"""Public wrappers around the port's kernels, and the tree <-> matrix layout.

Every wrapper follows the reference's convention set (``repro/kernels/
ops.py``, see docs/paper_map.md): the trailing model dim is padded with zeros
to a multiple of the kernel's tile (zeros leave the contraction unchanged),
and outputs are unpadded before return.  A CUDA tensor runs the hand-written
kernel; a CPU tensor runs its plain version.

* ``masked_scale_aggregate`` / ``tree_masked_aggregate`` — Eq. 2's masked
  unbiased aggregate ``G = sum_i mask_i (w_i / p_i) U_i`` on one device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.masked_aggregate import TILE, masked_scale_aggregate_cuda


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


def _tree_rebuild(like, leaves_iter):
    if isinstance(like, dict):
        return {k: _tree_rebuild(like[k], leaves_iter) for k in sorted(like)}
    return next(leaves_iter)


def tree_to_client_matrix(updates_tree) -> torch.Tensor:
    """Client-major ``(n, D)`` matrix of a tree of ``(n, ...)`` leaves.

    One concatenated copy in ``tree_leaves`` order (for the MLP:
    ``b1, b2, b3, w1, w2, w3``) — the layout the reference's kernels stream
    and ``client_matrix_to_tree`` inverts.
    """
    leaves = tree_leaves(updates_tree)
    n = leaves[0].shape[0]
    return torch.cat([leaf.reshape(n, -1) for leaf in leaves], dim=1)


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
    return _tree_rebuild(like_tree, iter(out))


def masked_scale_aggregate(updates: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(clients, D), (clients,) -> (D,) f32 ``sum_i scale_i * U_i``.

    ``scale`` already folds the Bernoulli mask and the ``w_i / p_i`` OCS
    reweighting (zero for unsampled clients), so this is the whole masked
    aggregation in one pass over the updates.  D is zero-padded to a multiple
    of the kernel's tile (which keeps every row aligned for its vector loads)
    and the result is unpadded.
    """
    d = updates.shape[1]
    pad = (-d) % TILE
    if pad:
        updates = F.pad(updates, (0, pad))
    return masked_scale_aggregate_cuda(updates, scale)[:d]


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
