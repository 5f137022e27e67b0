"""Bounded device cache of per-group client-update matrices for the
single-pass scan engine (``fl/engine.py``); a port of
``repro/kernels/update_cache.py``.

The master needs only the norm vector to fix the participation plan
(Eq. 7 / Alg. 2), so the scan engine streams clients in groups and lets each
group's updates die after their norm is taken, unless the group fits in the
cache: pass 1 parks the first ``cache_groups`` groups' update matrices — in
the client-major ``(scan_group, D)`` layout of ``ops.tree_to_client_matrix``
— in one ``(cache_groups, scan_group, D)`` buffer; after the plan, cached
groups aggregate straight from it and only the groups beyond capacity spill
to recomputing their updates.

* live update memory: O(cache_groups * scan_group * d);
* ``local_update`` evaluations per round:
  n + max(0, n - cache_groups * scan_group) — exactly n once the cache covers
  every group, 2n with ``cache_groups = 0`` (the two-pass engine).

Both backends share the cache semantics through :func:`group_norm_aggregate`
and :func:`group_compress_norm_aggregate`: ``'pallas'`` streams each group's
matrix through the fused CUDA kernels (``kernels/norm_aggregate.py``),
``'jnp'`` (the reference's name) is the plain torch contraction.
"""

from __future__ import annotations

import torch


def num_slots(cache_groups: int, n_groups: int) -> int:
    """Cache slots actually allocated: ``min(cache_groups, n_groups)`` (0
    means every group spills to recompute)."""
    return max(0, min(cache_groups, n_groups))


def local_update_evals(n_clients: int, scan_group: int, cache_groups: int) -> int:
    """Per-round ``local_update`` evaluations of the scan engine: every
    client once in pass 1, plus the groups beyond the cache's capacity once
    more after the plan."""
    n_groups = n_clients // scan_group
    spill_groups = n_groups - num_slots(cache_groups, n_groups)
    return n_clients + spill_groups * scan_group


def cache_bytes(cache_groups: int, scan_group: int, dim: int,
                itemsize: int = 4, n_groups: int | None = None) -> int:
    """Device bytes the cache holds: ``cache_groups * scan_group * d``
    elements of ``itemsize`` bytes.  ``n_groups`` clamps the capacity to the
    slots actually allocated (:func:`num_slots`)."""
    if n_groups is not None:
        cache_groups = num_slots(cache_groups, n_groups)
    return cache_groups * scan_group * dim * itemsize


def _contract(x: torch.Tensor, scale: torch.Tensor) -> tuple:
    """The plain backend's two reductions of an f32 ``(g, D)`` matrix."""
    return torch.sum(x * x, dim=-1), scale.to(torch.float32) @ x


def group_norm_aggregate(flat: torch.Tensor, scale: torch.Tensor, backend: str) -> tuple:
    """One group's ``(g, D)`` matrix + ``(g,)`` scale ->
    ``((g,) f32 squared norms, (D,) f32 aggregate partial)``.

    The scan engine's post-plan Eq. 2 contraction of a cached group.
    ``backend='pallas'`` runs the fused norm+aggregate kernel (one read of
    the matrix); ``'jnp'`` is the plain contraction.
    """
    if backend == "pallas":
        from repro_torch.kernels import ops

        return ops.norm_scale_aggregate(flat, scale)
    return _contract(flat.to(torch.float32), scale)


def group_compress_norm_aggregate(flat: torch.Tensor, scale: torch.Tensor,
                                  mats: tuple, kind: str, param: float,
                                  backend: str) -> tuple:
    """One group's RAW ``(g, D)`` matrix + material + ``(g,)`` scale ->
    ``((g,) f32 squared norms of C(U), (D,) f32 aggregate partial)``.

    The spill-to-recompute twin of :func:`group_norm_aggregate`: the material
    is regenerated from the same per-client keys as pass 1, so the values
    are bitwise what the cache would have held.  ``backend='pallas'`` runs the
    in-stream compress kernel (``C(U)`` never written); ``'jnp'`` compresses
    eagerly, casts through the transport dtype, and contracts.
    """
    if kind in (None, "none"):
        return group_norm_aggregate(flat, scale, backend)
    if backend == "pallas":
        from repro_torch.kernels import ops

        return ops.compress_norm_scale_aggregate(flat, scale, mats, kind, param)
    from repro_torch.core.compression import apply_compression_flat

    xc = apply_compression_flat(flat, kind, param, *[m.to(torch.float32) for m in mats])
    return _contract(xc.to(flat.dtype).to(torch.float32), scale)
