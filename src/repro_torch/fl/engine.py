"""The round engine: one federated communication round (Algorithm 3) under
two execution axes, ported from ``repro/fl/engine.py``.

* **memory policy** — how client updates are held while the master samples:

  - ``'vmap'``: all n client updates are computed at once (``torch.func.vmap``
    over the client axis of the batch) before sampling — O(n * d) live.
  - ``'scan'`` (single-pass OCS): clients run in groups of ``scan_group``; pass
    1 computes each group's (optionally compressed) updates once, takes their
    norms, and parks the first ``cache_groups`` groups' update matrices in a
    bounded cache (``kernels/update_cache.py``).  After the plan, cached
    groups aggregate straight from the cache and only the groups beyond its
    capacity recompute their updates.  The reference's ``lax.scan`` loops
    are Python loops over groups here.

* **aggregation backend** — how Eq. 2's ``G = sum_i mask_i (w_i/p_i) U_i``
  is contracted: ``'jnp'`` (plain torch) or ``'pallas'`` (the hand-written
  CUDA kernels: the masked aggregate on the vmap path, the fused
  norm+aggregate and compress+norm+aggregate on the scan path and under
  compression).

Unbiased compression (``fl.compression``: randk, qsgd, natural) composes with
both: each client compresses before its norm is taken (it reports the norm of
what it would send), from per-client keys ``split(k_comp, n)`` shared by every
path, so the compressed updates, the norms and the masks agree across
engines and backends.

The step consumes its key exactly as the reference's does
(``k_sample, k_comp = split(key)``; ``k_sample`` feeds ``sampling_plan``),
so the same key gives bitwise the reference's mask whenever the norms agree.
Partial availability (Appendix E) is the scalar ``fl.availability``, or the
round's :class:`~repro_torch.core.ocs.AvailabilityTrace` from the
client-state layer (the step's ``trace`` argument); a stateful sampler's
:class:`~repro_torch.core.sampling.SamplerState` rides in as
``sampler_state`` and out in ``RoundMetrics.sampler_state``.

``local_update`` follows the paper:
  * fedavg: R local SGD steps with lr eta_l, update U_i = x^k - y_{i,R}
  * dsgd  : U_i = g_i (stochastic gradient of the local batch)

With a mesh, :func:`make_engine` returns the mesh round of
``fl/shard_round.py`` instead: the clients sharded over the ranks of a
``torch.distributed`` process group, with explicit collectives.

The master applies the aggregate with plain ``lr_global`` SGD, or with a
server optimizer (``server_opt``, :mod:`repro_torch.optim`) on either memory
policy; the mesh round keeps plain SGD and rejects one.  Parameters are
nested dicts of tensors (the char-LM's ``gru{i}: {wx, wh, b}``), mapped leaf
by leaf with :func:`~repro_torch.kernels.ops.tree_map`.

``make_step(diag=True)`` is the observability variant: it contracts the
full-participation aggregate ``s = sum_i w_i U_i`` beside Eq. 2's sampled
one through the same backend path and returns ``‖ŝ − s‖²`` in
``RoundMetrics.gap`` (:mod:`repro_torch.obs.gap`).  :meth:`RoundEngine.
vmap_phases` cuts the vmap round into the five obs phases
(:class:`VmapPhases`), which the default step composes and the phased
executor (``repro_torch/obs/phased.py``) times one by one.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch.func import grad_and_value, vmap

from repro_torch import rng
from repro_torch._device import resolve_device
from repro_torch.configs.base import FLConfig
from repro_torch.core import ocs, sampling
from repro_torch.core.compression import COMPRESSORS, apply_compression, client_material
from repro_torch.kernels import ops as kops
from repro_torch.kernels import update_cache
from repro_torch.models.layers import BlockLoop
from repro_torch.obs.gap import flat_gap_stats, tree_gap_stats

MEMORY_POLICIES = ("vmap", "scan")


class RoundMetrics(NamedTuple):
    """Per-round observables: loss, alpha/gamma (Defs. 11/12), probs/mask.

    The trailing system-layer counters are zero (and ``selected_clients ==
    sent_clients``) when the round ran without an
    :class:`~repro_torch.core.ocs.AvailabilityTrace`: ``selected_clients``
    is the Bernoulli draw before attrition, ``deadline_misses`` the selected
    clients that missed the deadline, ``dropouts`` the selected on-time
    clients lost mid-round.  ``sampler_state`` is a stateful sampler's
    advanced :class:`~repro_torch.core.sampling.SamplerState` (``None``
    otherwise), which the caller feeds into the next round.  ``gap`` is a
    diagnostic round's :class:`~repro_torch.obs.gap.GapStats` (``None`` on a
    plain round).
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
    sampler_state: Any = None
    gap: Any = None


class VmapPhases(NamedTuple):
    """The vmap round as five phase callables (the obs contract).

    Made by :meth:`RoundEngine.vmap_phases`; composed in order —
    ``local_update`` -> ``compress`` -> ``sample`` -> ``aggregate`` ->
    ``server_opt`` — they are the vmap round step, op for op.
    """

    local_update: Callable   # (params, batch) -> (updates, losses)
    compress: Callable       # (updates, k_comp) -> (sendables, mats)
    sample: Callable         # (sendables, weights, k_sample, trace, st) -> plan
    aggregate: Callable      # (params, updates, sendables, mats, scale) -> agg
    server_opt: Callable     # (params, opt_state, agg) -> (params, opt_state)


def round_metrics(plan: ocs.SamplingPlan, loss: torch.Tensor, trace=None,
                  gap=None) -> RoundMetrics:
    """The round's :class:`RoundMetrics` from its plan, mean loss,
    availability trace (``None``: the system counters are zero) and, on a
    diagnostic round, its :class:`~repro_torch.obs.gap.GapStats`."""
    if trace is None:
        misses = drops = torch.zeros((), dtype=torch.int32, device=loss.device)
    else:
        misses = torch.sum(plan.selected & ~trace.on_time).to(torch.int32)
        drops = torch.sum(plan.selected & trace.on_time & ~trace.kept).to(torch.int32)
    return RoundMetrics(
        loss=loss,
        alpha=plan.alpha,
        gamma=plan.gamma,
        expected_clients=plan.expected_clients,
        sent_clients=torch.sum(plan.mask),
        probs=plan.probs,
        norms=plan.norms,
        mask=plan.mask,
        selected_clients=torch.sum(plan.selected).to(torch.int32),
        deadline_misses=misses,
        dropouts=drops,
        sampler_state=plan.sampler_state,
        gap=gap,
    )


def client_compression_material(updates, keys: torch.Tensor, fl: FLConfig) -> tuple:
    """Per-client compression material for a block of client updates.

    ``keys`` is the matching ``(block, 2)`` slice of ``split(k_comp,
    n_clients)`` — the per-client key contract every round path shares.
    Returns the tuple of material trees (leaves with the leading client
    axis); only call with ``fl.compression != 'none'``.
    """
    return client_material(updates, keys, fl.compression, fl.compression_param)


def client_apply_compression(updates, mats: tuple, fl: FLConfig):
    """Compressed client block from raw updates + material (elementwise)."""
    return apply_compression(updates, mats, fl.compression, fl.compression_param)


def compress_client_updates(updates, keys: torch.Tensor, fl: FLConfig):
    """Compress a block of client updates with per-client keys (a no-op when
    ``fl.compression == 'none'``): material, then the elementwise apply —
    the same two stages the fused kernels take, so the materialised and
    in-stream forms cannot diverge."""
    if fl.compression == "none":
        return updates
    mats = client_compression_material(updates, keys, fl)
    return client_apply_compression(updates, mats, fl)


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
            device = kops.tree_leaves(params)[0].device
            step_mask = torch.ones((fl.local_steps,), dtype=torch.float32, device=device)
        p, losses = params, []
        for r in range(fl.local_steps):
            g, loss = grad_fn(p, {k: v[r] for k, v in client_batch.items()})
            m = step_mask[r]
            # in f32, rounded once to the parameter's dtype: the reference's
            # (a - m * lr * b).astype(a.dtype) promotes a bf16 leaf against
            # the f32 step mask, where torch would round m * lr * b to bf16
            p = kops.tree_map(
                lambda a, b: (a - m * fl.lr_local * b.to(a.dtype).float()).to(a.dtype), p, g)
            losses.append(loss)
        update = kops.tree_map(lambda a, b: a - b, params, p)
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


def make_engine(loss_fn: Callable, fl: FLConfig, server_opt=None, *,
                mesh=None, device=None) -> Callable:
    """Round-step factory: the entry point callers should use.

    Returns ``round_step(params, opt_state, batch, weights, key, trace=None,
    sampler_state=None)``:

    * ``mesh=None`` — the single-device :class:`RoundEngine` configured by
      ``fl.round_engine`` x ``fl.agg_backend`` on ``device`` (``None`` means
      CUDA and raises when there is none; pass ``device='cpu'``);
    * a :class:`~repro_torch.fl.mesh.ClientMesh` — the mesh round of
      ``fl/shard_round.py`` on this rank (its device is the mesh's): clients
      sharded over the ranks, norms all-gathered (Alg. 2), Eq. 2's partial
      all-reduced.  It models the master step as plain ``lr_global`` SGD, so
      a ``server_opt`` raises ``ValueError`` there.

    Either way: Alg. 2 (or Eq. 7) probabilities from the clients' update
    norms, then Eq. 2's aggregate.
    """
    if mesh is None:
        return RoundEngine(loss_fn, fl, server_opt, device=device).make_step()
    if server_opt is not None:
        raise ValueError("server_opt is not supported on the shard_map path")
    from repro_torch.fl.shard_round import make_shard_map_round

    return make_shard_map_round(loss_fn, fl, mesh)


class RoundEngine:
    """Builds ``round_step`` for one (memory, backend) pair.

    ``round_step(params, opt_state, batch, weights, key, trace=None,
    sampler_state=None) -> (params, opt_state, RoundMetrics)`` — one
    communication round of Algorithm 3:
    local updates, norms ``u_i = ||w_i U_i||`` (Alg. 1 line 3),
    probabilities ``p_i`` (Eq. 7 exact / Alg. 2 approximate), independent
    Bernoulli participation, and the unbiased masked aggregate (Eq. 2).
    ``trace`` is the round's :class:`~repro_torch.core.ocs.AvailabilityTrace`
    (replacing ``fl.availability``), ``sampler_state`` a stateful sampler's
    carry.  Every tensor it is given must lie on the engine's device.

    Defaults come from the config (``fl.round_engine`` / ``fl.agg_backend`` /
    ``fl.scan_group`` / ``fl.cache_groups``); keyword arguments override them
    per instance.
    """

    def __init__(
        self,
        loss_fn: Callable,
        fl: FLConfig,
        server_opt=None,
        *,
        memory: str | None = None,
        backend: str | None = None,
        scan_group: int | None = None,
        cache_groups: int | None = None,
        device=None,
    ):
        self.fl = fl
        self.server_opt = server_opt
        self.device = resolve_device(device)
        self.memory = memory if memory is not None else fl.round_engine
        self.backend = backend if backend is not None else fl.agg_backend
        self.scan_group = scan_group if scan_group is not None else fl.scan_group
        self.cache_groups = cache_groups if cache_groups is not None else fl.cache_groups
        if self.memory not in MEMORY_POLICIES:
            raise ValueError(
                f"unknown memory policy {self.memory!r}; want one of {MEMORY_POLICIES}"
            )
        if self.backend not in ocs.AGG_BACKENDS:
            raise ValueError(
                f"unknown aggregation backend {self.backend!r}; "
                f"want one of {ocs.AGG_BACKENDS}"
            )
        if self.memory == "scan" and fl.n_clients % self.scan_group:
            raise ValueError(
                f"n_clients={fl.n_clients} not divisible by scan_group={self.scan_group}"
            )
        if self.cache_groups < 0:
            raise ValueError(f"cache_groups must be >= 0, got {self.cache_groups}")
        if fl.compression not in COMPRESSORS:
            raise ValueError(
                f"unknown compressor {fl.compression!r}; want one of {COMPRESSORS}"
            )
        if fl.algorithm not in ("fedavg", "dsgd"):
            raise ValueError(f"unknown algorithm {fl.algorithm!r}; want fedavg or dsgd")
        sampling.resolve_sampler(fl.sampler)
        self._local_update = make_local_update(loss_fn, fl)
        self._batched_update = vmap(self._local_update, in_dims=(None, 0))

    @property
    def local_update_evals(self) -> int:
        """Analytic ``local_update`` evaluations per round: n for vmap; for
        scan, n plus one recompute per client beyond the cache's capacity."""
        if self.memory == "vmap":
            return self.fl.n_clients
        return update_cache.local_update_evals(
            self.fl.n_clients, self.scan_group, self.cache_groups
        )

    def _check_devices(self, weights, key) -> None:
        for name, t in (("weights", weights), ("key", key)):
            if t.device.type != self.device.type:
                raise ValueError(
                    f"{name} lies on {t.device}, the engine runs on {self.device}"
                )

    def _plan(self, u, weights, k_sample, trace=None,
              sampler_state=None) -> ocs.SamplingPlan:
        fl = self.fl
        return ocs.sampling_plan(
            u, weights, fl.cohort_target(), k_sample,
            sampler=fl.sampler, j_max=fl.j_max,
            availability=fl.availability if trace is None else trace,
            sampler_state=sampler_state,
        )

    def _apply_server(self, params, opt_state, aggregate):
        if self.server_opt is None:
            lr = self.fl.lr_global
            new_params = kops.tree_map(lambda p, g: p - lr * g.to(p.dtype), params, aggregate)
            return new_params, opt_state
        return self.server_opt.update(aggregate, opt_state, params)

    def make_step(self, diag: bool = False) -> Callable:
        """The ``round_step`` for this engine's (memory, backend).

        ``diag=True`` builds the observability variant: the step also
        contracts the full-participation aggregate ``s = sum_i w_i U_i``
        through the same backend path (``scale = w`` in place of the plan's)
        and returns Eq. 2's ``‖ŝ − s‖²`` in ``RoundMetrics.gap``.  The
        default ``diag=False`` step runs exactly the ops it ran before the
        diagnostic existed, in the same order.
        """
        if self.memory == "vmap":
            return self._make_vmap_step(diag)
        return self._make_scan_step(diag)

    def vmap_phases(self) -> VmapPhases:
        """The vmap round cut into its five obs phases
        (:data:`~repro_torch.obs.trace.PHASES`), which compose into exactly
        the vmap round step: the same ops in the same order."""
        if self.memory != "vmap":
            raise ValueError(f"vmap_phases() needs memory='vmap', engine has {self.memory!r}")
        fl = self.fl

        def local_update(params, batch):
            return self._batched_update(params, batch)

        def compress(updates, k_comp):
            # each client compresses before its norm is taken: it reports
            # the norm of what it would send
            if fl.compression == "none":
                return updates, ()
            comp_keys = rng.split(k_comp, fl.n_clients)
            mats = client_compression_material(updates, comp_keys, fl)
            return client_apply_compression(updates, mats, fl), mats

        def sample(sendables, weights, k_sample, trace=None, sampler_state=None):
            return self._plan(ocs.client_norms(sendables, weights), weights, k_sample,
                              trace, sampler_state)

        def aggregate(params, updates, sendables, mats, scale):
            if fl.compression == "none":
                return ocs.aggregate_updates(updates, scale, backend=self.backend)
            if self.backend == "pallas":
                # the kernel re-applies the compressor in its tile stream from
                # the raw updates and the same material: no compressed (n, D)
                # matrix is written for the aggregate
                _, agg_flat = kops.compress_norm_scale_aggregate(
                    kops.tree_to_client_matrix(updates), scale,
                    tuple(kops.tree_to_client_matrix(m) for m in mats),
                    fl.compression, fl.compression_param,
                )
                return kops.client_matrix_to_tree(agg_flat, params, strip_client_axis=False)
            return ocs.aggregate_updates(sendables, scale, backend="jnp")

        return VmapPhases(local_update=local_update, compress=compress, sample=sample,
                          aggregate=aggregate, server_opt=self._apply_server)

    def _make_vmap_step(self, diag: bool = False) -> Callable:
        ph = self.vmap_phases()

        def round_step(params, opt_state, batch, weights, key, trace=None,
                       sampler_state=None):
            self._check_devices(weights, key)
            k_sample, k_comp = rng.split(key)
            updates, losses = ph.local_update(params, batch)
            sendables, mats = ph.compress(updates, k_comp)
            plan = ph.sample(sendables, weights, k_sample, trace, sampler_state)
            aggregate = ph.aggregate(params, updates, sendables, mats, plan.scale)
            gap = None
            if diag:
                # the full-participation aggregate through the same backend
                # path; at sampler='full' plan.scale == w bitwise, so the gap
                # is exactly zero
                full = ph.aggregate(params, updates, sendables, mats,
                                    weights.to(torch.float32))
                gap = tree_gap_stats(aggregate, full)
            new_params, new_opt = ph.server_opt(params, opt_state, aggregate)
            return new_params, new_opt, round_metrics(plan, torch.mean(losses), trace, gap)

        return round_step

    def _make_scan_step(self, diag: bool = False) -> Callable:
        fl = self.fl
        n, g = fl.n_clients, self.scan_group
        n_groups = n // g
        # the first n_cached groups' update matrices survive pass 1 in the
        # bounded cache; the n_groups - n_cached beyond it recompute post-plan
        n_cached = update_cache.num_slots(self.cache_groups, n_groups)

        def round_step(params, opt_state, batch, weights, key, trace=None,
                       sampler_state=None):
            self._check_devices(weights, key)
            k_sample, k_comp = rng.split(key)
            # the vmap path's per-client compression keys, re-derived for the
            # spill recompute, so compressed updates (hence norms, hence
            # masks) match on every engine
            comp_keys = rng.split(k_comp, n) if fl.compression != "none" else None

            def group(j):
                lo = j * g
                return ({k: v[lo:lo + g] for k, v in batch.items()},
                        None if comp_keys is None else comp_keys[lo:lo + g])

            leaves = kops.tree_leaves(params)
            dim = sum(leaf.numel() for leaf in leaves)
            dtype = leaves[0].dtype
            for leaf in leaves[1:]:
                dtype = torch.promote_types(dtype, leaf.dtype)
            cache = torch.empty((n_cached, g, dim), dtype=dtype, device=self.device)

            # pass 1: every group's updates once; norms from the same eager
            # ocs.client_norms as the vmap path (masks never depend on a kernel).
            # The groups have the same shapes: a dry-run counts one group of
            # each loop n times (models/layers.py::BlockLoop)
            norm_parts, loss_parts = [], []
            for lo, hi in ((0, n_cached), (n_cached, n_groups)):
                loop, norms, group_losses = BlockLoop(hi - lo, *leaves), [], []
                for j in loop:
                    j += lo
                    gb, keys = group(j)
                    upd, losses = self._batched_update(params, gb)
                    upd = compress_client_updates(upd, keys, fl)
                    norms.append(ocs.client_norms(upd, weights[j * g:(j + 1) * g]))
                    group_losses.append(losses)
                    if j < n_cached:
                        kops.tree_to_client_matrix(upd, out=cache[j])
                norm_parts += loop.fill(norms)
                loss_parts += loop.fill(group_losses)
            plan = self._plan(torch.cat(norm_parts), weights, k_sample, trace,
                              sampler_state)
            scale_g = plan.scale.reshape(n_groups, g)

            # post-plan: one flat f32 (D,) accumulator, group by group; the
            # squared norms the fused stream re-emits are discarded.  A
            # diagnostic round accumulates the full-participation aggregate
            # (scale = w) beside it in the same loops, so a spilled group is
            # recomputed once
            agg_flat = torch.zeros((dim,), dtype=torch.float32, device=self.device)
            if diag:
                wf_g = weights.to(torch.float32).reshape(n_groups, g)
                full_flat = torch.zeros((dim,), dtype=torch.float32, device=self.device)
            for j in BlockLoop(n_cached, *leaves):
                _, part = update_cache.group_norm_aggregate(cache[j], scale_g[j],
                                                            self.backend)
                agg_flat = agg_flat + part
                if diag:
                    _, full_part = update_cache.group_norm_aggregate(cache[j], wf_g[j],
                                                                     self.backend)
                    full_flat = full_flat + full_part
            for j in BlockLoop(n_groups - n_cached, *leaves):
                # spill: recompute the RAW updates and regenerate the material
                # from the same per-client keys; the compressor runs inside the
                # post-plan contraction
                j += n_cached
                gb, keys = group(j)
                upd, _ = self._batched_update(params, gb)
                mats = () if keys is None else tuple(
                    kops.tree_to_client_matrix(m)
                    for m in client_compression_material(upd, keys, fl)
                )
                flat = kops.tree_to_client_matrix(upd)
                _, part = update_cache.group_compress_norm_aggregate(
                    flat, scale_g[j], mats, fl.compression, fl.compression_param,
                    self.backend,
                )
                agg_flat = agg_flat + part
                if diag:
                    _, full_part = update_cache.group_compress_norm_aggregate(
                        flat, wf_g[j], mats, fl.compression, fl.compression_param,
                        self.backend,
                    )
                    full_flat = full_flat + full_part
            gap = flat_gap_stats(agg_flat, full_flat) if diag else None
            aggregate = kops.client_matrix_to_tree(agg_flat, params, strip_client_axis=False)
            new_params, new_opt = self._apply_server(params, opt_state, aggregate)
            return new_params, new_opt, round_metrics(plan, torch.mean(torch.cat(loss_parts)),
                                                      trace, gap)

        return round_step
