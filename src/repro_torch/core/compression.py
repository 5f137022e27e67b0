"""Unbiased communication-compression operators, composable with OCS.

A port of ``repro/core/compression.py``.  Each sampled client transmits
``C(U_i)`` instead of ``U_i``; since ``E[C(U)] = U`` the aggregate stays
unbiased, and the OCS probabilities are computed from the norms of the
compressed updates (what is actually sent):

* ``randk``   — random-k sparsification: keep exactly k coordinates, each
  scaled by its stratum size so ``E[C(x)] = x``;
* ``qsgd``    — QSGD stochastic quantization with s levels (relative to the
  leaf's norm);
* ``natural`` — natural compression: unbiased stochastic rounding of each
  magnitude to one of its two neighbouring powers of two.

Every compressor factors into two stages, as in the reference, so that the
fused kernels (``kernels/norm_aggregate.py``) can run the second one inside
their tile stream:

1. :func:`compression_material` — every random draw (and, for qsgd, the
   per-leaf norm), keyed by the reference's per-client subkey contract
   (``split(key, n_leaves)``, one key per leaf in ``tree_leaves`` order).
   The random bits are bitwise the reference's (``repro_torch.rng``).
2. :func:`apply_compression_flat` — a pure elementwise map ``(raw values,
   material...) -> compressed values`` with no randomness and no reduction.
   The CUDA kernel's ``__device__`` compressor repeats its arithmetic op for
   op, so compressing in the kernel is bitwise the same as compressing here
   on the card.

On the CPU, ``natural`` differs from the reference in the last bits of the
rounded-down power ``2**floor(log2|x|)``: XLA:CPU's ``exp2`` is inexact at
integer arguments (up to 1.01e-6 relative), torch's is exact.  XLA:CPU also
reads subnormal inputs as zero; torch does not.

Zero values with zero material compress to exact zero for every kind, which
is what makes the kernels' zero padding safe.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch import rng
from repro_torch.kernels.ops import tree_leaves as _leaves
from repro_torch.kernels.ops import tree_rebuild as _rebuild

# every compressor kind a config may name
COMPRESSORS = ("none", "randk", "qsgd", "natural")

# how many material trees compression_material returns per kind (the fused
# kernels take that many (clients, D) material matrices)
MATERIAL_ARITY = {"none": 0, "randk": 1, "qsgd": 2, "natural": 1}

_TINY = 2.0 ** -126     # the smallest normal float32


def _rand_k_gain(key: torch.Tensor, d: int, frac: float) -> torch.Tensor:
    """``(..., d)`` f32 rand-k gains for a key (or a ``(..., 2)`` batch of
    keys): stratified exact-k selection, as the reference draws it.

    Coordinates lie row-major on a ``(B+1, k)`` grid (``B = d // k``);
    column ``c`` is the stratum ``{c, c+k, ...}``.  One 32-bit draw per cell
    (cells past ``d`` masked to the maximum), the first argmin of each column
    is the kept coordinate, and its gain is the stratum size, so exactly k
    coordinates survive and ``E[gain_i] = 1``.
    """
    k = max(1, min(d, int(d * frac)))
    b, r = d // k, d % k
    dev = key.device
    rows = torch.arange(b + 1, dtype=torch.int64, device=dev)[:, None]
    cols = torch.arange(k, dtype=torch.int64, device=dev)[None, :]
    valid = rows * k + cols < d
    sizes = torch.where(torch.arange(k, device=dev) < r, float(b + 1), float(b)).to(torch.float32)
    g = torch.where(valid, rng.bits(key, (b + 1, k)), 0xFFFFFFFF)
    col_min = torch.amin(g, dim=-2, keepdim=True)
    eq = g == col_min
    keep = eq & (torch.cumsum(eq.to(torch.int32), dim=-2) == 1)   # first hit
    gain = keep.to(torch.float32) * sizes
    return gain.reshape(gain.shape[:-2] + ((b + 1) * k,))[..., :d]


def apply_compression_flat(x: torch.Tensor, kind: str, param: float,
                           *mats: torch.Tensor) -> torch.Tensor:
    """Elementwise compressed values from raw values + precomputed material.

    ``x`` and every entry of ``mats`` share one shape (a leaf, or a
    ``(n, D)`` client-major matrix).  Returns f32; callers cast back to the
    transport dtype.  The operations, their order and their operands' kinds
    (tensor or Python scalar) are the contract the CUDA compressor in
    ``kernels/csrc/ocs_tile.cuh`` repeats.
    """
    xf = x.to(torch.float32)
    if kind in (None, "none"):
        return xf
    if kind == "randk":
        (gain,) = mats
        return xf * gain
    if kind == "qsgd":
        u, nrm = mats
        levels = int(param)
        scaled = torch.where(
            nrm > 0, torch.abs(xf) / torch.clamp(nrm, min=1e-30) * levels, 0.0
        )
        low = torch.floor(scaled)
        q = low + (u < scaled - low)
        return torch.sign(xf) * q * nrm / levels
    if kind == "natural":
        (u,) = mats
        mag = torch.abs(xf)
        sub = mag < _TINY
        low = torch.where(
            sub, 0.0, torch.exp2(torch.floor(torch.log2(torch.clamp(mag, min=_TINY))))
        )
        hi = torch.where(sub, _TINY, 2.0 * low)
        prob = torch.where(sub, mag / _TINY, mag / torch.clamp(low, min=_TINY) - 1.0)
        return torch.sign(xf) * torch.where(u < prob, hi, low)
    raise ValueError(f"unknown compressor {kind!r}; want one of {COMPRESSORS}")


def client_material(updates: Any, keys: torch.Tensor, kind: str, param: float) -> tuple:
    """Compression material for a block of clients at once.

    ``updates`` is a tree of ``(n, ...)`` leaves and ``keys`` the matching
    ``(n, 2)`` per-client keys; the result is bitwise ``jax.vmap`` of the
    reference's ``compression_material`` over the block (one cipher call per
    leaf for the whole block).  Returns ``MATERIAL_ARITY[kind]`` trees of f32
    leaves shaped like the update leaves.
    """
    if kind in (None, "none"):
        return ()
    if kind not in MATERIAL_ARITY:
        raise ValueError(f"unknown compressor {kind!r}; want one of {COMPRESSORS}")
    leaves = _leaves(updates)
    n = keys.shape[0]
    leaf_keys = rng.split(keys, len(leaves))            # (n, n_leaves, 2)
    firsts, seconds = [], []
    for i, leaf in enumerate(leaves):
        key, size = leaf_keys[:, i], leaf[0].numel()
        if kind == "randk":
            firsts.append(_rand_k_gain(key, size, param).reshape(leaf.shape))
            continue
        firsts.append(rng.uniform(key, (size,)).reshape(leaf.shape))
        if kind == "qsgd":
            flat = leaf.reshape(n, -1).to(torch.float32)
            nrm = torch.sqrt(torch.sum(flat * flat, dim=1))
            seconds.append(nrm.reshape((n,) + (1,) * (leaf.dim() - 1)).expand(leaf.shape)
                           .contiguous())
    mats = (firsts, seconds) if kind == "qsgd" else (firsts,)
    return tuple(_rebuild(updates, iter(m)) for m in mats)


def compression_material(update: Any, key: torch.Tensor, kind: str, param: float) -> tuple:
    """All compression randomness for ONE client's update (the reference's
    ``compression_material``): :func:`client_material` on a block of one."""
    block = _rebuild(update, iter([leaf[None] for leaf in _leaves(update)]))
    mats = client_material(block, key[None], kind, param)
    return tuple(
        _rebuild(update, iter([leaf[0] for leaf in _leaves(m)])) for m in mats
    )


def apply_compression(update: Any, mats: tuple, kind: str, param: float) -> Any:
    """Compressed update tree from raw tree + material, cast to leaf dtypes
    (with or without a leading client axis)."""
    if kind in (None, "none"):
        return update
    mat_leaves = [_leaves(m) for m in mats]
    out = [
        apply_compression_flat(leaf, kind, param, *ms).to(leaf.dtype)
        for leaf, *ms in zip(_leaves(update), *mat_leaves)
    ]
    return _rebuild(update, iter(out))


def rand_k_leaf(x: torch.Tensor, frac: float, key: torch.Tensor) -> torch.Tensor:
    """Exact-k random sparsification of one leaf (stratified, unbiased)."""
    gain = _rand_k_gain(key, x.numel(), frac).reshape(x.shape)
    return apply_compression_flat(x, "randk", frac, gain).to(x.dtype)


def qsgd_leaf(x: torch.Tensor, levels: int, key: torch.Tensor) -> torch.Tensor:
    """QSGD stochastic quantization of one leaf to ``levels`` levels."""
    flat = x.reshape(-1)
    u = rng.uniform(key, flat.shape)
    f32 = flat.to(torch.float32)
    nrm = torch.sqrt(torch.sum(f32 * f32)).expand(flat.shape)
    out = apply_compression_flat(flat, "qsgd", levels, u, nrm)
    return out.reshape(x.shape).to(x.dtype)


def natural_leaf(x: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Unbiased rounding of each ``|x|`` to a neighbouring power of two
    (magnitudes below ``2**-126`` round between 0 and ``2**-126``)."""
    flat = x.reshape(-1)
    u = rng.uniform(key, flat.shape)
    out = apply_compression_flat(flat, "natural", 0.0, u)
    return out.reshape(x.shape).to(x.dtype)


def compress_update(update: Any, key: torch.Tensor, kind: str, param: float) -> Any:
    """Apply an unbiased compressor leaf-wise to one client's update tree."""
    if kind in (None, "none"):
        return update
    mats = compression_material(update, key, kind, param)
    return apply_compression(update, mats, kind, param)


def compressed_bits_per_update(dim: int, kind: str, param: float) -> int:
    """Uplink bits for one transmitted (compressed) update of ``dim`` params."""
    if kind in (None, "none"):
        return dim * 32
    if kind == "randk":
        k = max(1, min(dim, int(dim * param)))
        return k * (32 + max(1, math.ceil(math.log2(max(dim, 2)))))
    if kind == "qsgd":
        s = int(param)
        return dim * (math.ceil(math.log2(s + 1)) + 1) + 32
    if kind == "natural":
        return dim * 9  # sign + 8-bit exponent per coordinate
    raise ValueError(kind)
