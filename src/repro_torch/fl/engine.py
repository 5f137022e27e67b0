"""The round engine: one federated communication round (Algorithm 3).

Ported from ``repro/fl/engine.py`` for the ``'vmap'`` memory policy: all n
client updates are computed at once (``torch.func.vmap`` over the client
axis of the batch), then the master takes their norms, draws the sampling
plan and contracts Eq. 2's masked aggregate
``G = sum_i mask_i * (w_i/p_i) * U_i`` through the configured backend
(``'jnp'``: per-leaf torch contraction; ``'pallas'``: the hand-written CUDA
kernel), and takes the plain ``lr_global`` server step.  Partial
availability (Appendix E) is the scalar ``fl.availability``.

The step consumes its key exactly as the reference's vmap step does
(``k_sample, k_comp = split(key)``; ``k_sample`` feeds ``sampling_plan``),
so the same key gives bitwise the reference's mask whenever the norms agree.

``local_update`` follows the paper:
  * fedavg: R local SGD steps with lr eta_l, update U_i = x^k - y_{i,R}
  * dsgd  : U_i = g_i (stochastic gradient of the local batch)

Not ported yet, each raising ``NotImplementedError``: the ``'scan'`` memory
policy and compression (the scan-engine slice), a server optimizer (the
optimizer slice), the mesh (the mesh slice).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.func import grad_and_value, vmap

from repro_torch import rng
from repro_torch._device import resolve_device
from repro_torch.configs.base import FLConfig
from repro_torch.core import ocs, sampling

MEMORY_POLICIES = ("vmap", "scan")


class RoundMetrics(NamedTuple):
    """Per-round observables: loss, alpha/gamma (Defs. 11/12), probs/mask.

    The system-layer counters are zero and ``selected_clients ==
    sent_clients``: the availability-trace layer is not ported yet.
    """

    loss: torch.Tensor
    alpha: torch.Tensor
    gamma: torch.Tensor
    expected_clients: torch.Tensor
    sent_clients: torch.Tensor
    probs: torch.Tensor
    norms: torch.Tensor
    mask: torch.Tensor
    selected_clients: torch.Tensor
    deadline_misses: torch.Tensor
    dropouts: torch.Tensor


def make_local_update(loss_fn: Callable, fl: FLConfig):
    """loss_fn: (params, batch) -> (scalar, metrics dict).  Returns
    ``local_update(params, client_batch) -> (update, loss)`` for one client."""
    grad_fn = grad_and_value(lambda p, b: loss_fn(p, b)[0])

    def fedavg_update(params, client_batch):
        # `_step_mask` (R,) emulates "one local epoch": clients with little
        # data take fewer effective steps (masked), as in the paper's setup.
        client_batch = dict(client_batch)
        step_mask = client_batch.pop("_step_mask", None)
        if step_mask is None:
            device = next(iter(params.values())).device
            step_mask = torch.ones((fl.local_steps,), dtype=torch.float32, device=device)
        p, losses = params, []
        for r in range(fl.local_steps):
            g, loss = grad_fn(p, {k: v[r] for k, v in client_batch.items()})
            m = step_mask[r]
            p = {k: p[k] - m * fl.lr_local * g[k].to(p[k].dtype) for k in p}
            losses.append(loss)
        update = {k: params[k] - p[k] for k in params}
        loss = torch.sum(torch.stack(losses) * step_mask) / torch.clamp(
            torch.sum(step_mask), min=1.0
        )
        return update, loss

    def dsgd_update(params, client_batch):
        client_batch = dict(client_batch)
        client_batch.pop("_step_mask", None)
        batch = {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in client_batch.items()}
        g, loss = grad_fn(params, batch)
        return g, loss

    return fedavg_update if fl.algorithm == "fedavg" else dsgd_update


def _not_ported(what: str, slice_name: str):
    return NotImplementedError(
        f"{what} is not ported yet: it lands with the {slice_name} slice of the port"
    )


def make_engine(loss_fn: Callable, fl: FLConfig, server_opt=None, *,
                mesh=None, device=None) -> Callable:
    """Round-step factory: the entry point callers should use.

    Returns ``round_step(params, opt_state, batch, weights, key)`` for the
    single-device :class:`RoundEngine` configured by ``fl.round_engine`` x
    ``fl.agg_backend``: Alg. 2 (or Eq. 7) probabilities from the clients'
    update norms, then Eq. 2's aggregate.  ``device=None`` means CUDA and
    raises when there is none (pass ``device='cpu'``).  A mesh is not ported
    yet.
    """
    if mesh is not None:
        raise _not_ported("the mesh (shard) round", "mesh")
    return RoundEngine(loss_fn, fl, server_opt, device=device).make_step()


class RoundEngine:
    """Builds ``round_step`` for the config's (memory, backend) pair.

    ``round_step(params, opt_state, batch, weights, key) -> (params,
    opt_state, RoundMetrics)`` — one communication round of Algorithm 3:
    local updates, norms ``u_i = ||w_i U_i||`` (Alg. 1 line 3),
    probabilities ``p_i`` (Eq. 7 exact / Alg. 2 approximate), independent
    Bernoulli participation, and the unbiased masked aggregate (Eq. 2).
    Every tensor it is given must lie on the engine's device.
    """

    def __init__(self, loss_fn: Callable, fl: FLConfig, server_opt=None, *, device=None):
        self.fl = fl
        self.device = resolve_device(device)
        self.memory = fl.round_engine
        self.backend = fl.agg_backend
        if self.memory not in MEMORY_POLICIES:
            raise ValueError(
                f"unknown memory policy {self.memory!r}; want one of {MEMORY_POLICIES}"
            )
        if self.backend not in ocs.AGG_BACKENDS:
            raise ValueError(
                f"unknown aggregation backend {self.backend!r}; "
                f"want one of {ocs.AGG_BACKENDS}"
            )
        if self.memory == "scan":
            raise _not_ported("memory='scan' (the single-pass scan engine)", "scan-engine")
        if fl.compression != "none":
            raise _not_ported(f"compression={fl.compression!r}", "compression")
        if server_opt is not None:
            raise _not_ported("a server optimizer", "optimizer")
        if fl.algorithm not in ("fedavg", "dsgd"):
            raise ValueError(f"unknown algorithm {fl.algorithm!r}; want fedavg or dsgd")
        sampling.resolve_sampler(fl.sampler)
        self._local_update = make_local_update(loss_fn, fl)

    def _apply_server(self, params, opt_state, aggregate):
        lr = self.fl.lr_global
        new_params = {k: params[k] - lr * aggregate[k].to(params[k].dtype) for k in params}
        return new_params, opt_state

    def _metrics(self, plan: ocs.SamplingPlan, losses) -> RoundMetrics:
        zero = torch.zeros((), dtype=torch.int32, device=losses.device)
        return RoundMetrics(
            loss=torch.mean(losses),
            alpha=plan.alpha,
            gamma=plan.gamma,
            expected_clients=plan.expected_clients,
            sent_clients=torch.sum(plan.mask),
            probs=plan.probs,
            norms=plan.norms,
            mask=plan.mask,
            selected_clients=torch.sum(plan.selected).to(torch.int32),
            deadline_misses=zero,
            dropouts=zero,
        )

    def make_step(self) -> Callable:
        """The vmap ``round_step`` (``_make_vmap_step`` in the reference)."""
        fl = self.fl
        batched_update = vmap(self._local_update, in_dims=(None, 0))

        def round_step(params, opt_state, batch, weights, key):
            for name, t in (("weights", weights), ("key", key)):
                if t.device.type != self.device.type:
                    raise ValueError(
                        f"{name} lies on {t.device}, the engine runs on {self.device}"
                    )
            k_sample, _ = rng.split(key)
            updates, losses = batched_update(params, batch)
            u = ocs.client_norms(updates, weights)
            plan = ocs.sampling_plan(
                u, weights, fl.cohort_target(), k_sample,
                sampler=fl.sampler, j_max=fl.j_max, availability=fl.availability,
            )
            aggregate = ocs.aggregate_updates(updates, plan.scale, backend=self.backend)
            new_params, new_opt = self._apply_server(params, opt_state, aggregate)
            return new_params, new_opt, self._metrics(plan, losses)

        return round_step
