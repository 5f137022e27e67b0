"""The mesh round: the FL round with the clients sharded over the ranks of a
:class:`~repro_torch.fl.mesh.ClientMesh` and the paper's communication
pattern spelled out as collectives (``repro/fl/shard_round.py``).

  step                              collective (over the ranks)
  ------------------------------   ---------------------------
  C(U_i) = compress(U_i)            none (local, per-client key)
  u_i = ||w_i C(U_i)||              none (local reduce)
  master aggregates norms (Alg. 2)  all_gather of one float / client
  p_i, mask_i                       local, deterministic given key
  G = sum_i mask_i (w_i/p_i) C(U_i) all_reduce of one (D,) partial

Each rank owns ``k = n_clients / world_size`` clients, its ``rank``-th
block; the model is not sharded.  Compression runs on the rank's block with
its slice of the same ``split(k_comp, n)`` per-client keys the
single-device engines derive, so the norms (hence the masks, hence the
uplink bill) are the engines'.  Every rank runs the same
``ocs.sampling_plan`` on the gathered norms and weights, so the plan is
replicated.  The round's :class:`~repro_torch.core.ocs.AvailabilityTrace`
and a stateful sampler's ``SamplerState`` are replicated too: every rank
steps the same client state from the same round key (the reference passes
them in with ``P()``), so no collective carries them.

Eq. 2's aggregate follows ``fl.agg_backend``:

* ``'jnp'`` — per-leaf contraction of the block, one ``all_reduce`` per
  leaf;
* ``'pallas'`` — the rank's block through the hand-written CUDA kernel
  (``kernels/sharded_aggregate.py``; with compression, the kernel compresses
  the raw block in its tile stream), then one ``all_reduce`` of the ``(D,)``
  partial.

At one rank every collective is the identity, so the round equals the vmap
engine's (bitwise, on the pallas backend at ``k`` up to the kernel's client
block).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.func import vmap

from repro_torch import rng
from repro_torch.configs.base import FLConfig
from repro_torch.core import ocs, sampling
from repro_torch.core.compression import COMPRESSORS
from repro_torch.fl.engine import (
    client_apply_compression,
    client_compression_material,
    make_local_update,
    round_metrics,
)
from repro_torch.kernels import ops as kops


def validate_shard_config(fl: FLConfig, axis_size: int) -> None:
    """Reject an unsupported config before anything touches a key, the numpy
    generator or a collective.  Raises ``ValueError`` with the reference's
    messages."""
    sampling.resolve_sampler(fl.sampler)  # ValueError listing SAMPLERS on unknown names
    if fl.agg_backend not in ocs.AGG_BACKENDS:
        raise ValueError(
            f"unknown aggregation backend {fl.agg_backend!r}; "
            f"want one of {ocs.AGG_BACKENDS}"
        )
    if fl.compression not in COMPRESSORS:
        raise ValueError(
            f"unknown compressor {fl.compression!r}; want one of {COMPRESSORS}"
        )
    if fl.n_clients % axis_size:
        raise ValueError(
            f"n_clients={fl.n_clients} must divide by the client-axis size "
            f"{axis_size} (each shard owns n_clients/axis_size clients)"
        )


def make_shard_map_round(loss_fn: Callable, fl: FLConfig, mesh) -> Callable:
    """Returns ``round_step(params, opt_state, batch, weights, key,
    trace=None, sampler_state=None) -> (params, opt_state, RoundMetrics)``
    for this rank of ``mesh``.

    Called on every rank.  ``params``, ``key``, ``trace`` (the whole
    cohort's) and ``sampler_state`` are the same on every rank;
    ``batch`` (leaves ``(k, ...)``) and ``weights`` (``(k,)``) are the rank's
    slices of the round's cohort, on ``mesh.device``.  Every rank returns the
    same parameters and metrics.  The config is validated here, before any
    key is split, and the mesh's axis must be ``fl.client_axis`` (the
    reference's ``shard_map`` fails on a mesh without that axis).
    """
    validate_shard_config(fl, mesh.world_size)
    if mesh.axis_name != fl.client_axis:
        raise ValueError(
            f"the mesh's axis is {mesh.axis_name!r}, not fl.client_axis="
            f"{fl.client_axis!r}: build the mesh with build_client_mesh(fl)"
        )
    batched_update = vmap(make_local_update(loss_fn, fl), in_dims=(None, 0))
    n = fl.n_clients
    k = n // mesh.world_size
    lo = mesh.rank * k

    def round_step(params, opt_state, batch, weights, key, trace=None, sampler_state=None):
        for name, t in (("weights", weights), ("key", key)):
            if t.device != mesh.device:
                raise ValueError(f"{name} lies on {t.device}, the mesh's rank on {mesh.device}")
        if weights.shape != (k,):
            raise ValueError(f"want this rank's ({k},) weights, got {tuple(weights.shape)}")
        updates, losses = batched_update(params, batch)
        # the engines' key discipline, so the same round key draws the same
        # compression material and participation mask on every path
        k_sample, k_comp = rng.split(key)
        if fl.compression != "none":
            # this rank's slice of the engines' per-client keys (not split(k_comp, k))
            comp_keys = rng.split(k_comp, n)[lo:lo + k]
            mats = client_compression_material(updates, comp_keys, fl)
            compressed = client_apply_compression(updates, mats, fl)
        else:
            mats = ()
            compressed = updates
        # each client reports the norm of what it sends; the master sees
        # only the gathered scalars, and every rank runs the same plan
        u_all = mesh.all_gather(ocs.client_norms(compressed, weights))
        w_all = mesh.all_gather(weights)
        plan = ocs.sampling_plan(
            u_all, w_all, fl.cohort_target(), k_sample,
            sampler=fl.sampler, j_max=fl.j_max,
            availability=fl.availability if trace is None else trace,
            sampler_state=sampler_state,
        )
        scale = plan.scale[lo:lo + k]
        if fl.agg_backend == "pallas" and fl.compression != "none":
            # the raw block and its material stream through the kernel,
            # which compresses in its tile stream; one all_reduce
            aggregate = kops.tree_shard_compress_aggregate(
                updates, scale, mats, fl.compression, fl.compression_param, mesh,
            )
        elif fl.agg_backend == "pallas":
            aggregate = kops.tree_shard_masked_aggregate(compressed, scale, mesh)
        else:
            def agg(leaf):
                s = scale.reshape((k,) + (1,) * (leaf.dim() - 1))
                return mesh.all_reduce(torch.sum(leaf.to(torch.float32) * s, dim=0))

            aggregate = kops.tree_map(agg, compressed)
        lr = fl.lr_global
        new_params = kops.tree_map(lambda p, g: p - lr * g.to(p.dtype), params, aggregate)
        loss = mesh.pmean(torch.mean(losses))
        return new_params, opt_state, round_metrics(plan, loss, trace)

    return round_step
