"""Counter-based random keys with jax.random's threefry2x32 bit layout.

The reference derives every random decision from explicit keys: the round
key is ``fold_in(PRNGKey(seed), 1000 + k)`` and every participation mask is
``bernoulli`` of a split of it.  Reproducing that algorithm (threefry2x32,
20 rounds, with ``jax_threefry_partitionable=True`` — the jax 0.9 default)
lets the port draw the same masks as the reference from the same seed, which
is what makes the two ledgers comparable round by round.

A key is an int64 tensor of shape ``(2,)`` holding two uint32 words; every
function runs on the key's device.  ``split``, ``bits`` and ``uniform`` also
take a ``(..., 2)`` batch of keys and draw for all of them in one cipher call
(bitwise ``jax.vmap`` of the single-key form): the compressor's per-client,
per-leaf material is drawn that way, since each cipher call is some 170
small device ops.  All
arithmetic is int64 masked with ``& 0xFFFFFFFF``, because torch's uint32
arithmetic is partial.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0: torch.Tensor, x1: torch.Tensor):
    """The threefry2x32 block cipher (20 rounds) on uint32 words held in
    int64: key words ``k0, k1`` (broadcastable) and counters ``x0, x1``."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _MASK
    x1 = (x1 + k1) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: the words ``(0, seed)``."""
    seed = int(seed)
    if not -(2**31) <= seed < 2**31:
        raise ValueError(f"seed must fit in int32, got {seed}")
    return torch.tensor([0, seed & _MASK], dtype=torch.int64, device=device)


def _counts(shape, device):
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return (idx >> 32).reshape(shape), (idx & _MASK).reshape(shape)


def _key_words(key: torch.Tensor, ndim: int):
    """The two words of a key, or of a ``(..., 2)`` batch of keys, shaped to
    broadcast against ``ndim`` trailing counter dims."""
    pad = (slice(None),) * (key.dim() - 1) + (None,) * ndim
    return key[..., 0][pad], key[..., 1][pad]


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``(num, 2)`` new keys, key ``i`` = cipher of counter ``i``.

    A ``(..., 2)`` batch of keys gives ``(..., num, 2)``: bitwise ``jax.vmap``
    of the single-key form, in one cipher call over the whole batch.
    """
    hi, lo = _counts((num,), key.device)
    y0, y1 = threefry2x32(*_key_words(key, 1), hi, lo)
    return torch.stack([y0, y1], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: the cipher of the counter pair ``(0, data)``.

    The counters are fills on the key's device, not a copy from host
    memory, so a round key costs no stream sync."""
    x0 = torch.zeros((1,), dtype=torch.int64, device=key.device)
    x1 = torch.full((1,), int(data) & _MASK, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[0], key[1], x0, x1)
    return torch.cat([y0, y1])


def fold_in_many(key: torch.Tensor, data) -> torch.Tensor:
    """``(len(data), 2)`` keys, row ``i`` bitwise ``fold_in(key, data[i])``,
    in one cipher call (the driver's scan mode draws a block's round keys so,
    on the host)."""
    data = torch.tensor([int(d) & _MASK for d in data], dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[0], key[1], torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def bits(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.bits`` (uint32): the two cipher words of each element's
    flat row-major index XORed, returned as int64 in ``[0, 2**32)``.

    A ``(..., 2)`` batch of keys gives ``(..., *shape)``, bitwise ``jax.vmap``
    of the single-key form.
    """
    shape = tuple(shape)
    hi, lo = _counts(shape, key.device)
    y0, y1 = threefry2x32(*_key_words(key, len(shape)), hi, lo)
    return y0 ^ y1


def uniform(key: torch.Tensor, shape=(), minval=0.0, maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: 23 random mantissa bits under the
    exponent of 1.0, minus 1, then scaled to ``[minval, maxval)``.  Takes a
    batch of keys as :func:`bits` does."""
    b = bits(key, shape)
    floats = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # the bounds and their difference in float32, as jax forms them, passed
    # as Python scalars (exact in float32): no host-to-device copy
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)
    return torch.clamp(floats * span + float(lo), min=float(lo))


def bernoulli(key: torch.Tensor, p, shape=None) -> torch.Tensor:
    """``jax.random.bernoulli``: ``uniform(key, shape) < p`` (bool)."""
    if shape is None:
        shape = tuple(p.shape) if isinstance(p, torch.Tensor) else ()
    u = uniform(key, shape)
    if isinstance(p, torch.Tensor):
        p = p.to(device=u.device, dtype=torch.float32)
    else:
        p = float(np.float32(p))      # a scalar exact in float32: no copy
    return u < p


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2)))
# Giles' single-precision erfinv ("Approximating the erfinv function", GPU
# Computing Gems), the polynomial XLA lowers ``lax.erf_inv`` to: one set of
# Horner coefficients for w = -log1p(-x^2) < 5, another for the tails.
_ERFINV_CENTRAL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                   -4.39150654e-06, 0.00021858087, -0.00125372503,
                   -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_TAIL = (-0.000200214257, 0.000100950558, 0.00134934322,
                -0.00367342844, 0.00573950773, -0.0076224613,
                0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function with XLA's polynomial, so that
    :func:`normal` follows the reference to within float32 rounding."""
    w = -torch.log1p(x * -x)
    central = w < 5.0
    w = torch.where(central, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(central, _ERFINV_CENTRAL[0], _ERFINV_TAIL[0])
    for a, b in zip(_ERFINV_CENTRAL[1:], _ERFINV_TAIL[1:]):
        p = torch.where(central, a, b) + p * w
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2) * erfinv(u)`` for ``u``
    uniform on ``(-1, 1)``.  ``log1p`` and the polynomial's rounding may
    differ from XLA's in the last bit, so this agrees with the reference to
    float32 rounding rather than bitwise."""
    u = uniform(key, shape, _NORMAL_LO, 1.0)
    return erfinv(u) * _SQRT2
