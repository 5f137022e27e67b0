"""The OCS aggregation layer: norms -> probabilities -> Bernoulli masks ->
unbiased weighted aggregate (paper Eq. 2 with Algorithm 1/2 probabilities).

Ported from ``repro/core/ocs.py``.  ``sampling_plan`` holds the sampling
math every round path shares (the only place the Bernoulli draws and the
``_EPS`` guards live) and consumes the key exactly as the reference does, so
the same norms and key give bitwise the same mask; ``aggregate_updates`` is
the swappable heavy contraction (``'jnp'``: per-leaf torch contraction;
``'pallas'``: the hand-written CUDA kernel via ``kernels/ops.py``).

Availability enters as the scalar ``q`` of Appendix E, or as a per-client
:class:`AvailabilityTrace` from the client-state layer
(``sim/pool.py::step_client_state``), which generalises it.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch import rng
from repro_torch.core import sampling
from repro_torch.core.improvement import improvement_factors
from repro_torch.kernels.ops import tree_leaves, tree_map

_EPS = 1e-12

AGG_BACKENDS = ("jnp", "pallas")


class OCSResult(NamedTuple):
    """One OCS round's outputs: Eq. 2's aggregate plus the sampling record."""

    aggregate: Any                  # tree, same structure as one client's update
    probs: torch.Tensor             # (n,) inclusion probabilities
    mask: torch.Tensor              # (n,) realized Bernoulli participation
    norms: torch.Tensor             # (n,) weighted update norms ||w_i U_i||
    alpha: torch.Tensor             # improvement factor (Def. 11)
    gamma: torch.Tensor             # relative improvement factor (Def. 12)
    expected_clients: torch.Tensor  # sum(p) <= m


class SamplingPlan(NamedTuple):
    """Everything the master decides from the (n,) norm vector alone.

    ``scale`` is the per-client coefficient of the unbiased estimator
    ``mask_i * w_i / (p_i * q)`` (zero for unsampled clients), so any backend
    realises the aggregate as the single contraction ``sum_i scale_i U_i``.
    ``selected`` is the Bernoulli draw before deadline and dropout attrition
    (``mask`` on the scalar-availability paths); ``sampler_state`` the
    advanced :class:`~repro_torch.core.sampling.SamplerState` of a stateful
    sampler, ``None`` otherwise.
    """

    probs: torch.Tensor
    mask: torch.Tensor
    scale: torch.Tensor
    avail: torch.Tensor
    selected: torch.Tensor
    norms: torch.Tensor
    alpha: torch.Tensor
    gamma: torch.Tensor
    expected_clients: torch.Tensor
    sampler_state: Any = None


class AvailabilityTrace(NamedTuple):
    """One round's realised client-state availability for the (n,) cohort.

    ``up`` is the Markov chain's state, known before sampling (a down
    client's norm is zeroed and it is never selected); ``on_time`` and
    ``kept`` are attrition after selection (a selected client can miss the
    deadline or drop mid-round).  ``include_prob`` is each client's marginal
    inclusion probability over the whole process, ``P(up) P(on_time)
    P(kept)``, which the estimator divides by.  Made by
    :func:`repro_torch.sim.pool.step_client_state`.
    """

    up: torch.Tensor            # (n,) bool
    on_time: torch.Tensor       # (n,) bool
    kept: torch.Tensor          # (n,) bool
    include_prob: torch.Tensor  # (n,) f32


def client_norms(updates: Any, weights: torch.Tensor) -> torch.Tensor:
    """``u_i = ||w_i U_i||`` per client; every leaf has leading axis n."""
    leaves = tree_leaves(updates)
    n = leaves[0].shape[0]
    sq = torch.zeros((n,), dtype=torch.float32, device=leaves[0].device)
    for leaf in leaves:
        x = leaf.to(torch.float32)
        sq = sq + torch.sum(x * x, dim=tuple(range(1, x.dim())))
    return weights.to(torch.float32) * torch.sqrt(sq)


def sampling_plan(
    norms: torch.Tensor,
    weights: torch.Tensor,
    m: int,
    key: torch.Tensor,
    sampler: str | Callable = "aocs",
    j_max: int = 4,
    availability: float | AvailabilityTrace = 1.0,
    sampler_state: Any = None,
) -> SamplingPlan:
    """Norms -> probabilities -> Bernoulli mask -> estimator coefficients.

    Inclusion probabilities ``p_i`` (Eq. 7 exact via ``sampler='optimal'``,
    Alg. 2 via ``'aocs'``, or any other ``SAMPLERS`` entry), the independent
    Bernoulli participation draw (Alg. 1 line 5), partial availability
    (Appendix E, when ``availability < 1``: a split of ``key`` draws who is
    reachable, and unreachable clients get norm 0), the improvement factors
    alpha/gamma (Defs. 11/12), and ``scale_i = mask_i * w_i / (p_i * q)``.

    ``availability`` may instead be an :class:`AvailabilityTrace`: down
    clients get norm 0, the draw is recorded as ``selected``, the mask is
    ``selected & on_time & kept``, and the estimator divides by the trace's
    ``include_prob``.  The trace is drawn outside (from its own fold of the
    round key), so this path consumes ``key`` exactly as ``availability ==
    1`` does.  Stateful samplers (``cyclic``, ``threshold``) take
    ``sampler_state`` (a fresh one when ``None``) and return the advanced
    state in the plan's ``sampler_state``.

    Deterministic in ``key``, which it consumes in the reference's order, so
    the same norms and key give bitwise the reference's mask.
    """
    fn = sampling.resolve_sampler(sampler)
    u = norms
    n = u.shape[0]
    trace = availability if isinstance(availability, AvailabilityTrace) else None
    if trace is not None:
        avail = trace.up & trace.on_time & trace.kept
        u = torch.where(trace.up, u, torch.zeros_like(u))     # down clients never send
        q = trace.include_prob
    elif availability < 1.0:
        k_avail, key = rng.split(key)
        avail = rng.bernoulli(k_avail, availability, shape=(n,)).to(u.device)
        u = torch.where(avail, u, torch.zeros_like(u))
        q = availability
    else:
        avail = torch.ones((n,), dtype=torch.bool, device=u.device)
        q = 1.0
    if fn is sampling.aocs_probabilities:
        p = fn(u, m, j_max)
    elif sampling.is_stateful(fn):
        if sampler_state is None:
            sampler_state = sampling.init_sampler_state(u.device)
        p, sampler_state = fn(u, m, sampler_state)
    else:
        p = fn(u, m)
        sampler_state = None
    bern = rng.bernoulli(key, torch.clamp(p, 0.0, 1.0), shape=(n,)).to(u.device)
    if trace is not None:
        selected = bern & trace.up
        mask = selected & trace.on_time & trace.kept
    else:
        selected = mask = bern & avail
    w = weights.to(torch.float32)
    scale = torch.where(mask & (p > _EPS), w / torch.clamp(p * q, min=_EPS),
                        torch.zeros_like(w))
    alpha, gamma = improvement_factors(u, m)
    return SamplingPlan(
        probs=p,
        mask=mask,
        scale=scale,
        avail=avail,
        selected=selected,
        norms=u,
        alpha=alpha,
        gamma=gamma,
        expected_clients=torch.sum(p),
        sampler_state=sampler_state,
    )


def aggregate_updates(updates: Any, scale: torch.Tensor, backend: str = "jnp") -> Any:
    """``sum_i scale_i * U_i`` over the leading client axis of every leaf.

    The heavy half of Eq. 2: with ``scale`` from :func:`sampling_plan` this
    is the unbiased masked aggregate ``G = sum_i mask_i (w_i/p_i) U_i``.
    ``backend='jnp'``: per-leaf torch contraction (the name is the
    reference's).  ``backend='pallas'``: the hand-written masked-aggregate
    kernel over the client-major matrix (``kernels/ops.py``); on CPU tensors
    its plain version.
    """
    if backend == "jnp":
        n = scale.shape[0]

        def agg(leaf):
            s = scale.reshape((n,) + (1,) * (leaf.dim() - 1)).to(leaf.dtype)
            return torch.sum(leaf * s, dim=0)

        return tree_map(agg, updates)
    if backend == "pallas":
        from repro_torch.kernels import ops

        return ops.tree_masked_aggregate(updates, scale)
    raise ValueError(f"unknown aggregation backend {backend!r}; want one of {AGG_BACKENDS}")


def sample_and_aggregate(
    updates: Any,
    weights: torch.Tensor,
    m: int,
    key: torch.Tensor,
    sampler: str | Callable = "aocs",
    j_max: int = 4,
    norms: torch.Tensor | None = None,
    availability: float = 1.0,
    backend: str = "jnp",
) -> OCSResult:
    """One round of optimal client sampling.

    ``updates`` is a tree of per-client updates (every leaf ``(n, ...)``),
    ``weights`` the ``(n,)`` client weights ``w_i``, ``m`` the expected
    number of communicating clients, ``key`` the participation key.  Returns
    an :class:`OCSResult` whose ``aggregate`` is the unbiased estimator
    ``sum_i mask_i * (w_i / p_i) * U_i`` of the full update ``sum_i w_i U_i``.
    """
    u = client_norms(updates, weights) if norms is None else norms
    plan = sampling_plan(
        u, weights, m, key, sampler=sampler, j_max=j_max, availability=availability
    )
    aggregate = aggregate_updates(updates, plan.scale, backend=backend)
    return OCSResult(
        aggregate=aggregate,
        probs=plan.probs,
        mask=plan.mask,
        norms=plan.norms,
        alpha=plan.alpha,
        gamma=plan.gamma,
        expected_clients=plan.expected_clients,
    )
