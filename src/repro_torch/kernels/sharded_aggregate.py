"""A rank's half of Eq. 2 on the GPU, with and without in-stream compression.

The hand-written CUDA kernels of ``csrc/sharded_aggregate.cu`` replace two
TPU kernels of the mesh round:

* :func:`sharded_masked_aggregate_cuda` — ``repro/kernels/
  sharded_aggregate.py::sharded_masked_aggregate_pallas``: the rank's
  ``(k, D)`` client block and its ``(k,)`` scale -> the ``(D,)`` f32
  partial ``sum_i s_i U_i``;
* :func:`sharded_compress_aggregate_cuda` — ``repro/kernels/
  sharded_aggregate.py::sharded_compress_aggregate_pallas``: the same on
  ``C(U)``, compressed in the tile stream from the raw block and its
  material, plus the ``(k,)`` squared norms of ``C(U)``.

The caller all-reduces the partial over the ranks (``ops.shard_*``).  The
grid has a client-block axis of :data:`BLOCK_CLIENTS` clients, as the TPU
kernels' has, for a rank that owns many clients: each block's CTAs fold
their clients in order, and with more than one block the blocks' partials
are added in block order (no atomics on values).  So at
``k <= BLOCK_CLIENTS`` the aggregate equals ``masked_scale_aggregate_cuda``'s
(and the compressed one ``compress_norm_scale_aggregate_cuda``'s) bitwise,
the norms equal ``compress_norm_scale_aggregate_cuda``'s at every ``k``, and
``kind='none'`` equals :func:`sharded_masked_aggregate_cuda`.

The first takes a padded matrix (D a multiple of 4, aligned rows) and adds
the blocks' partials in a second launch.  The second runs one launch on the
unpadded ``(k, D)`` matrices at any element-aligned start: the last CTA of
each client block sums its clients' norm partials, and the last CTA of each
D tile adds the blocks' partials, each told by a ticket counter of the
stream's (``norm_aggregate._counters``).

Each wrapper launches its kernel for CUDA tensors and raises on anything it
cannot take; for CPU tensors it returns the plain version.  Its ``launches``
attribute counts its launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.masked_aggregate import TILE, masked_scale_aggregate_ref
from repro_torch.kernels.norm_aggregate import (
    KINDS,
    _SUFFIX,
    _check,
    _check_compressor,
    _counters,
    _levels,
    _material_ptrs,
    _on_cpu,
    _raise_on,
    _scratch,
    _vector,
    compress_norm_scale_aggregate_ref,
)

BLOCK_CLIENTS = 128                      # kBlockClients in the source
MAX_CLIENTS = 65535 * BLOCK_CLIENTS      # the grid's client-block axis
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = {
    "sharded_masked_aggregate": [_P] * 4 + [_I] * 2 + [_P],
    "sharded_compress_aggregate": [_P] * 9 + [_I] * 4 + [_F] * 2 + [_P],
}

# the plain versions: the single-device ones over the rank's block
sharded_masked_aggregate_ref = masked_scale_aggregate_ref
sharded_compress_aggregate_ref = compress_norm_scale_aggregate_ref


def _kernel_fn(name: str, dtype):
    fn = getattr(_build.load("sharded_aggregate"), f"{name}_{_SUFFIX[dtype]}")
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _block_partials(c: int, width: int, dev) -> torch.Tensor | None:
    """Each client block's partial of the aggregate, ``width`` columns a row,
    when there is more than one block; the kernel writes the output directly
    otherwise."""
    blocks = -(-c // BLOCK_CLIENTS)
    if blocks == 1:
        return None
    return torch.empty((blocks, width), dtype=torch.float32, device=dev)


def sharded_masked_aggregate_cuda(updates: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """A rank's (k, D) f32/bf16 block, (k,) f32 -> (D,) f32 partial
    ``sum_i scale_i * U_i``.

    CUDA tensors run the kernel (or raise); CPU tensors run the plain version.
    """
    if _on_cpu(updates, scale):
        return sharded_masked_aggregate_ref(updates, scale)
    c, d = _check(updates, scale, max_clients=MAX_CLIENTS)
    dev = updates.device
    out = torch.empty((d,), dtype=torch.float32, device=dev)
    if d == 0:
        return out
    blockpart = _block_partials(c, d, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _kernel_fn("sharded_masked_aggregate", updates.dtype)(
        updates.data_ptr(), scale.data_ptr(),
        0 if blockpart is None else blockpart.data_ptr(), out.data_ptr(), c, d, stream,
    )
    _raise_on(rc, "sharded_masked_aggregate")
    sharded_masked_aggregate_cuda.launches += 1
    return out


def sharded_compress_aggregate_cuda(updates: torch.Tensor, scale: torch.Tensor,
                                    mats: tuple, kind: str, param: float):
    """A rank's raw (k, D) f32/bf16 block + ``MATERIAL_ARITY[kind]`` (k, D)
    f32 material, (k,) f32 scale -> ((k,) f32 squared norms of C(U), (D,) f32
    partial ``sum_i scale_i * C(U_i)``), compressed in the tile stream, in
    one launch.

    Any D and any start addresses of contiguous matrices.  The launch uses
    the current stream's ticket counters (``norm_aggregate._counters``): a
    call on another stream gets its own and gives the same result.  CUDA
    tensors run the kernel (or raise); CPU tensors run the plain version.
    """
    mats = _check_compressor(kind, mats)
    if _on_cpu(updates, scale, *mats):
        return sharded_compress_aggregate_ref(updates, scale, mats, kind, param)
    c, d = _check(updates, scale, mats, max_clients=MAX_CLIENTS, any_width=True)
    dev = updates.device
    sq = torch.empty((c,), dtype=torch.float32, device=dev)
    out = torch.empty((d,), dtype=torch.float32, device=dev)
    if d == 0:
        return sq.zero_(), out
    levels, inv_levels = _levels(kind, param)
    ptrs = _material_ptrs(mats)
    partials = _scratch(c, d, dev)
    tiles = -(-d // TILE)
    blockpart = _block_partials(c, tiles * TILE, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    counters = _counters(dev, stream, -(-c // BLOCK_CLIENTS) + tiles)
    rc = _kernel_fn("sharded_compress_aggregate", updates.dtype)(
        updates.data_ptr(), scale.data_ptr(), ptrs[0], ptrs[1], partials.data_ptr(),
        sq.data_ptr(), 0 if blockpart is None else blockpart.data_ptr(), out.data_ptr(),
        counters.data_ptr(), c, d, _vector(d, updates, *mats), KINDS[kind], levels,
        inv_levels, stream,
    )
    _raise_on(rc, "sharded_compress_aggregate")
    sharded_compress_aggregate_cuda.launches += 1
    return sq, out


sharded_masked_aggregate_cuda.launches = 0
sharded_compress_aggregate_cuda.launches = 0
