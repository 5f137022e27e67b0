"""Public wrappers around the port's kernels, and the tree <-> matrix layout.

Every wrapper follows the reference's convention set (``repro/kernels/
ops.py``, see docs/paper_map.md): the trailing model dim is padded with zeros
to a multiple of the kernel's tile (zeros leave the contraction unchanged),
and outputs are unpadded before return.  A CUDA tensor runs the hand-written
kernel; a CPU tensor runs its plain version.

* ``client_sqnorms`` / ``tree_client_norms`` — Alg. 1 line 3 / Alg. 2 input:
  ``u_i = ||w_i U_i||``.
* ``masked_scale_aggregate`` / ``tree_masked_aggregate`` — Eq. 2's masked
  unbiased aggregate ``G = sum_i mask_i (w_i / p_i) U_i`` on one device.
* ``norm_scale_aggregate`` — both reductions from one read (the scan
  engine's post-plan pass over each group).
* ``compress_norm_scale_aggregate`` — the same on ``C(U)``, compressed in the
  tile stream from the raw updates and their material (material matrices
  are zero-padded with the updates: zero in, zero out for every kind).
* ``shard_masked_aggregate`` / ``tree_shard_masked_aggregate`` and
  ``shard_compress_aggregate`` / ``tree_shard_compress_aggregate`` — the
  mesh round's Eq. 2: a rank's partial over its own client block, then one
  ``all_reduce`` over the mesh; ``sharded_masked_aggregate`` — the same from
  the global matrix, each rank taking its block.
* ``flash_attention`` — ``(BH, S, d)`` causal attention with an optional
  sliding window and bidirectional prefix; also ``(B, S, H, d)`` strided
  views, as the hybrid model's prefill passes them.
* ``ssd_scan`` — the chunked Mamba2 SSD scan; S is padded to a chunk
  multiple with ``dt = da = 0`` identity steps and unpadded on return;
  ``ssd_scan_heads`` — the same on the model's ``(B, S, H, P)`` and
  ``(B, S, G, N)`` views, read in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.masked_aggregate import TILE, masked_scale_aggregate_cuda
from repro_torch.kernels.norm_aggregate import (
    client_sqnorms_cuda,
    compress_norm_scale_aggregate_cuda,
    norm_scale_aggregate_cuda,
)
from repro_torch.kernels.sharded_aggregate import (
    sharded_compress_aggregate_cuda,
    sharded_masked_aggregate_cuda,
)
from repro_torch.kernels.ssd_scan import ssd_scan_cuda, ssd_scan_heads_cuda


def tree_leaves(tree) -> list:
    """Leaves of a nested dict in jax's ``tree_leaves`` order (sorted keys)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree):
    """``fn`` applied to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_rebuild(like, leaves_iter):
    """A tree shaped like ``like`` whose leaves are taken, in ``tree_leaves``
    order, from ``leaves_iter``."""
    if isinstance(like, dict):
        return {k: tree_rebuild(like[k], leaves_iter) for k in sorted(like)}
    return next(leaves_iter)


def tree_to_client_matrix(updates_tree, out: torch.Tensor | None = None) -> torch.Tensor:
    """Client-major ``(n, D)`` matrix of a tree of ``(n, ...)`` leaves.

    One concatenated copy in ``tree_leaves`` order (for the MLP:
    ``b1, b2, b3, w1, w2, w3``) — the layout the reference's kernels stream
    and ``client_matrix_to_tree`` inverts.  ``out`` (an ``(n, D)`` tensor,
    e.g. a slot of the scan engine's update cache) receives the copy.
    """
    leaves = tree_leaves(updates_tree)
    n = leaves[0].shape[0]
    parts = [leaf.reshape(n, -1) for leaf in leaves]
    if out is None:
        return torch.cat(parts, dim=1)
    return torch.cat(parts, dim=1, out=out)


def client_matrix_to_tree(vec: torch.Tensor, like_tree, strip_client_axis: bool,
                          keep_dtype: bool = False):
    """Split a flat ``(D,)`` vector back into ``like_tree``'s leaf layout.

    ``strip_client_axis``: leaves of ``like_tree`` carry a leading client axis
    not present in ``vec``.  ``keep_dtype`` casts each output leaf to its
    template leaf's dtype (else ``vec``'s dtype).
    """
    out, off = [], 0
    for leaf in tree_leaves(like_tree):
        shape = leaf.shape[1:] if strip_client_axis else leaf.shape
        size = leaf[0].numel() if strip_client_axis else leaf.numel()
        piece = vec[off:off + size].reshape(shape)
        out.append(piece.to(leaf.dtype) if keep_dtype else piece)
        off += size
    return tree_rebuild(like_tree, iter(out))


def _pad_cols(x: torch.Tensor, pad: int) -> torch.Tensor:
    return F.pad(x, (0, pad)) if pad else x


def client_sqnorms(updates: torch.Tensor) -> torch.Tensor:
    """(clients, D) -> (clients,) f32 squared norms in one pass (D zero-padded
    to the kernel's tile)."""
    return client_sqnorms_cuda(_pad_cols(updates, (-updates.shape[1]) % TILE))


def tree_client_norms(updates_tree, weights: torch.Tensor) -> torch.Tensor:
    """Kernel-backed equivalent of ``core.ocs.client_norms``:
    ``u_i = w_i * ||U_i||`` over a tree of ``(n, ...)`` leaves."""
    sq = client_sqnorms(tree_to_client_matrix(updates_tree))
    return weights.to(torch.float32) * torch.sqrt(sq)


def norm_scale_aggregate(updates: torch.Tensor, scale: torch.Tensor) -> tuple:
    """(clients, D), (clients,) -> ((clients,) sq norms, (D,) aggregate).

    Both OCS reductions from one read of the updates: the per-client squared
    norms behind ``u_i = ||w_i U_i||`` and Eq. 2's ``sum_i scale_i U_i``.
    The scan engine calls it on each cached group after the plan.
    """
    d = updates.shape[1]
    sq, agg = norm_scale_aggregate_cuda(_pad_cols(updates, (-d) % TILE), scale)
    return sq, agg[:d]


def compress_norm_scale_aggregate(updates: torch.Tensor, scale: torch.Tensor,
                                  mats: tuple, kind: str, param: float) -> tuple:
    """Raw (clients, D) + material -> ((clients,) sq norms of C(U),
    (D,) aggregate of C(U)), compression fused into the aggregate stream.

    The compressor runs elementwise on each tile of the raw values and its
    ``MATERIAL_ARITY[kind]`` material matrices, and both reductions take the
    compressed tile: one read of each update, no ``C(U)`` written.  D pads
    with zeros on the updates AND the material.
    """
    d = updates.shape[1]
    pad = (-d) % TILE
    sq, agg = compress_norm_scale_aggregate_cuda(
        _pad_cols(updates, pad), scale, tuple(_pad_cols(m, pad) for m in mats),
        kind, param,
    )
    return sq, agg[:d]


def masked_scale_aggregate(updates: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(clients, D), (clients,) -> (D,) f32 ``sum_i scale_i * U_i``.

    ``scale`` already folds the Bernoulli mask and the ``w_i / p_i`` OCS
    reweighting (zero for unsampled clients), so this is the whole masked
    aggregation in one pass over the updates.  D is zero-padded to a multiple
    of the kernel's tile (which keeps every row aligned for its vector loads)
    and the result is unpadded.
    """
    d = updates.shape[1]
    return masked_scale_aggregate_cuda(_pad_cols(updates, (-d) % TILE), scale)[:d]


def tree_masked_aggregate(updates_tree, scale: torch.Tensor):
    """Kernel-backed masked aggregate over a tree of ``(n, ...)`` leaves.

    Concatenates the tree into the client-major ``(n, D)`` matrix, runs the
    aggregate, and splits the result back to the leaf shapes (cast to each
    leaf's dtype).
    """
    flat = tree_to_client_matrix(updates_tree)
    agg = masked_scale_aggregate(flat, scale)
    return client_matrix_to_tree(agg, updates_tree, strip_client_axis=True,
                                 keep_dtype=True)


def shard_masked_aggregate(updates: torch.Tensor, scale: torch.Tensor,
                           mesh=None) -> torch.Tensor:
    """A rank's ``(k, D)``, ``(k,)`` -> the ``(D,)`` f32 aggregate summed
    over the mesh.

    The mesh form of Eq. 2: the kernel contracts the rank's own client block
    in one pass, then one ``all_reduce`` over ``mesh`` (a
    :class:`~repro_torch.fl.mesh.ClientMesh`) completes ``sum_i scale_i U_i``
    — one partial sum per rank, no ``(n, D)`` matrix anywhere.
    ``mesh=None`` skips the sum.  D pads with zeros to the kernel's tile; the
    client axis needs no padding (the kernel's last client block may be
    short).
    """
    d = updates.shape[1]
    out = sharded_masked_aggregate_cuda(_pad_cols(updates, (-d) % TILE), scale)[:d]
    return out if mesh is None else mesh.all_reduce(out)


def tree_shard_masked_aggregate(updates_tree, scale: torch.Tensor, mesh=None):
    """:func:`shard_masked_aggregate` over a rank's tree of ``(k, ...)``
    leaves: the block's client-major matrix, the kernel, one ``all_reduce``,
    and the ``(D,)`` result split back to the leaf shapes (cast to each
    leaf's dtype)."""
    agg = shard_masked_aggregate(tree_to_client_matrix(updates_tree), scale, mesh)
    return client_matrix_to_tree(agg, updates_tree, strip_client_axis=True,
                                 keep_dtype=True)


def shard_compress_aggregate(updates: torch.Tensor, scale: torch.Tensor, mats: tuple,
                             kind: str, param: float, mesh=None) -> tuple:
    """A rank's raw ``(k, D)`` block + material -> ``((k,) sq norms of
    C(U), (D,) f32 aggregate of C(U) summed over the mesh)``, compression
    fused into the kernel's tile stream.  ``mesh=None`` skips the sum.  D
    pads with zeros on the updates and the material."""
    d = updates.shape[1]
    pad = (-d) % TILE
    sq, out = sharded_compress_aggregate_cuda(
        _pad_cols(updates, pad), scale, tuple(_pad_cols(m, pad) for m in mats),
        kind, param,
    )
    out = out[:d]
    return sq, (out if mesh is None else mesh.all_reduce(out))


def tree_shard_compress_aggregate(updates_tree, scale: torch.Tensor, mats: tuple,
                                  kind: str, param: float, mesh=None):
    """:func:`shard_compress_aggregate` over a rank's tree of raw ``(k, ...)``
    leaves and its material trees.  The squared norms the kernel emits are
    discarded: the plan's norms come from the eager ``ocs.client_norms``, so
    masks never depend on a kernel."""
    _, agg = shard_compress_aggregate(
        tree_to_client_matrix(updates_tree), scale,
        tuple(tree_to_client_matrix(m) for m in mats), kind, param, mesh,
    )
    return client_matrix_to_tree(agg, updates_tree, strip_client_axis=True,
                                 keep_dtype=True)


def sharded_masked_aggregate(updates: torch.Tensor, scale: torch.Tensor, mesh) -> torch.Tensor:
    """The global ``(n, D)``, ``(n,)`` -> the ``(D,)`` f32 aggregate, on every
    rank of ``mesh``: each rank contracts only its own ``(n / world_size, D)``
    block and one ``all_reduce`` sums the partials.  ``n`` must divide by the
    world size."""
    n = updates.shape[0]
    if n % mesh.world_size:
        raise ValueError(f"n={n} clients must divide by the mesh's {mesh.world_size} ranks")
    k = n // mesh.world_size
    lo = mesh.rank * k
    return shard_masked_aggregate(updates[lo:lo + k], scale[lo:lo + k], mesh)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, window=None,
                    prefix: int = 0) -> torch.Tensor:
    """(BH, S, d) causal flash attention (optional window / prefix-LM), kv
    already head-repeated; the kernel masks the ragged end of S itself.  The
    same on (B, S, H, d) views with any 16-byte strides (d contiguous), which
    the kernel reads in place."""
    return flash_attention_cuda(q, k, v, window=window, prefix=prefix)


def ssd_scan(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor, dt: torch.Tensor,
             da: torch.Tensor, *, chunk: int = 128) -> tuple:
    """Chunked SSD scan (Mamba2).  x (BH,S,P), b and c (BH,S,N), dt and da
    (BH,S) -> (y (BH,S,P) f32, final state (BH,P,N) f32).  S is padded to a
    chunk multiple with dt = da = 0 steps, which leave the state unchanged."""
    s = x.shape[1]
    pad = (-s) % chunk
    if pad:
        x, b, c = (F.pad(t, (0, 0, 0, pad)) for t in (x, b, c))
        dt, da = (F.pad(t, (0, pad)) for t in (dt, da))
    y, state = ssd_scan_cuda(x, b, c, dt, da, chunk=chunk)
    return y[:, :s], state


def ssd_scan_heads(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor, dt: torch.Tensor,
                   da: torch.Tensor, *, chunk: int = 128) -> tuple:
    """The chunked SSD scan on the model's layout: x (B,S,H,P), b and c
    (B,S,G,N) with G 1 or H, views with the last axis contiguous, which the
    kernel reads in place; dt and da (B,S,H) f32; S a chunk multiple -> (y
    (B,S,H,P) f32, final state (B,H,P,N) f32)."""
    return ssd_scan_heads_cuda(x, b, c, dt, da, chunk=chunk)
