"""Per-client squared norms and the fused norm + Eq. 2 aggregate on the GPU,
with and without in-stream compression.

The hand-written CUDA kernels of ``csrc/norm_aggregate.cu`` replace three
TPU kernels:

* :func:`client_sqnorms_cuda` — ``repro/kernels/client_norm.py::
  client_sqnorms_pallas``: ``(C, D) -> (C,)`` f32 ``sum_d U_id^2``;
* :func:`norm_scale_aggregate_cuda` — ``repro/kernels/norm_aggregate.py::
  norm_scale_aggregate_pallas``: the squared norms and ``sum_i s_i U_i``
  from one read of U (the scan engine's post-plan pass);
* :func:`compress_norm_scale_aggregate_cuda` — ``repro/kernels/
  norm_aggregate.py::compress_norm_scale_aggregate_pallas``: the same on
  ``C(U)``, compressed in the tile stream from the raw values and their
  material (``core/compression.py``), ``C(U)`` never written.

All three share one tile layout and one reduction code (``csrc/
ocs_tile.cuh``), with a fixed summation order and no atomics on values: the
norms of all three are equal bitwise, the second's aggregate equals
``masked_scale_aggregate_cuda``'s, the third with ``kind='none'`` equals the
second, and the third equals "compress eagerly on the card, then the second".
On an H100 each is bound by device memory, and at the round's shapes by
launch and memory latency.  Each runs one launch on any contiguous ``(C,
D)`` matrix at any element-aligned start: the CTA that finishes last sums
the per-CTA norm partials in the fixed order, which it knows from a ticket
counter (see :func:`_counters`).

Each wrapper launches its kernel for CUDA tensors and raises on anything it
cannot take; for CPU tensors it returns the plain version beside it.  Its
``launches`` attribute counts its launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.masked_aggregate import (
    COLS_PER_THREAD,
    MAX_CLIENTS,
    THREADS,
    TILE,
    masked_scale_aggregate_ref,
)

WARPS = THREADS // 32          # kWarps in the source: norm partials per CTA
KINDS = {"none": 0, "randk": 1, "qsgd": 2, "natural": 3}    # kNone.. in the source
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = {
    "client_sqnorms": [_P] * 4 + [_I] * 3 + [_P],
    "norm_scale_aggregate": [_P] * 6 + [_I] * 3 + [_P],
    "compress_norm_scale_aggregate": [_P] * 8 + [_I] * 4 + [_F] * 2 + [_P],
}
_counter_buffers: dict = {}


def client_sqnorms_ref(updates: torch.Tensor) -> torch.Tensor:
    """(clients, D) -> (clients,) f32 squared norms."""
    x = updates.to(torch.float32)
    return torch.sum(x * x, dim=-1)


def norm_scale_aggregate_ref(updates: torch.Tensor, scale: torch.Tensor):
    """(clients, D), (clients,) -> ((clients,) sq norms, (D,) aggregate)."""
    return client_sqnorms_ref(updates), masked_scale_aggregate_ref(updates, scale)


def compress_norm_scale_aggregate_ref(updates, scale, mats, kind, param):
    """Compress the raw ``(clients, D)`` matrix with its material (cast
    through the transport dtype), then both reductions on ``C(U)``."""
    from repro_torch.core.compression import apply_compression_flat

    xc = apply_compression_flat(updates, kind, param,
                                *[m.to(torch.float32) for m in mats])
    xc = xc.to(updates.dtype).to(torch.float32)
    return client_sqnorms_ref(xc), masked_scale_aggregate_ref(xc, scale)


def _kernel_fn(name: str, dtype):
    fn = getattr(_build.load("norm_aggregate"), f"{name}_{_SUFFIX[dtype]}")
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _check_matrix(name: str, x: torch.Tensor, dev, shape, dtypes, any_width) -> None:
    if x.device != dev:
        raise ValueError(f"{name} must lie on {dev}, got {x.device}")
    if x.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"want {name} of shape {shape}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if not any_width and x.data_ptr() % (COLS_PER_THREAD * x.element_size()):
        raise ValueError(f"{name} must start on a {COLS_PER_THREAD}-element boundary")


def _check(updates: torch.Tensor, scale=None, mats=(), max_clients=MAX_CLIENTS,
           any_width=False) -> tuple:
    """Validate the inputs for the kernel; returns ``(C, D)``.  Without
    ``any_width`` D must be a multiple of 4 and every matrix start on a
    4-element boundary (the vector loads of the padded kernels)."""
    if updates.device.type != "cuda":
        raise ValueError(f"updates must lie on a CUDA device, got {updates.device}")
    if updates.dim() != 2:
        raise ValueError(f"want updates (C, D), got {tuple(updates.shape)}")
    c, d = updates.shape
    if d % COLS_PER_THREAD and not any_width:
        raise ValueError(
            f"D must be a multiple of {COLS_PER_THREAD} (the ops wrappers pad it), got D={d}"
        )
    if not 0 < c <= max_clients or d >= 2**31:
        raise ValueError(
            f"shape beyond the kernel's limits: C={c} (1 to {max_clients}), D={d} (below 2**31)"
        )
    _check_matrix("updates", updates, updates.device, (c, d), tuple(_SUFFIX), any_width)
    if scale is not None:
        _check_vector(scale, updates.device, c)
    for j, m in enumerate(mats):
        _check_matrix(f"material {j}", m, updates.device, (c, d), (torch.float32,), any_width)
    return c, d


def _check_vector(scale: torch.Tensor, dev, c: int) -> None:
    if scale.device != dev:
        raise ValueError(f"scale must lie on {dev}, got {scale.device}")
    if scale.dtype != torch.float32:
        raise TypeError(f"scale must be float32, got {scale.dtype}")
    if tuple(scale.shape) != (c,) or not scale.is_contiguous():
        raise ValueError(f"want a contiguous scale of shape ({c},), got {tuple(scale.shape)}")


def _scratch(c: int, d: int, dev) -> torch.Tensor:
    """The per-(client, CTA, warp) norm partials, one per client per 128
    columns (a CTA covers ``TILE`` columns, the last one partly past D); the
    caching allocator hands this memory out again only to work queued after
    the kernels on the same stream."""
    return torch.empty((c, -(-d // TILE) * WARPS), dtype=torch.float32, device=dev)


def _counters(dev, stream: int, n: int = 1) -> torch.Tensor:
    """The kernels' ticket counters for ``(dev, stream)``: int32, zeroed when
    first asked for and kept, and replaced by a larger zeroed buffer when a
    launch needs more (``n``) than it holds.  Each launch counts its CTAs on
    its first counters and its last CTAs set them back to 0, so launches on
    one stream, which run in order, share them (kernels 2, 3, 4 and 6 take
    the same buffer); a launch on another stream gets a buffer of its own,
    so launches that may overlap never share one."""
    key = (dev.index, stream)
    buf = _counter_buffers.get(key)
    if buf is None or buf.numel() < n:
        buf = _counter_buffers[key] = torch.zeros((max(n, 64),), dtype=torch.int32, device=dev)
    return buf


def _vector(d: int, *mats) -> int:
    """Elements per load for the one-launch kernels: 2 where D and every
    matrix's start address are even in elements (with a row stride of D,
    every row is then aligned to it), else 1.  The kernels take no wider
    load: 16-byte loads ran slower in them on the H100 (``PERF.md`` §6,
    PR 18)."""
    even = d % 2 == 0 and all(m.data_ptr() % (2 * m.element_size()) == 0 for m in mats)
    return 2 if even else 1


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check_compressor(kind: str, mats) -> tuple:
    """Validate the compressor kind and its number of material matrices."""
    # imported here: core.compression imports this package
    from repro_torch.core.compression import MATERIAL_ARITY

    if kind not in KINDS:
        raise ValueError(f"unknown compressor {kind!r}; want one of {tuple(KINDS)}")
    mats = tuple(mats)
    if len(mats) != MATERIAL_ARITY[kind]:
        raise ValueError(
            f"compressor {kind!r} takes {MATERIAL_ARITY[kind]} material matrices, "
            f"got {len(mats)}"
        )
    return mats


def _levels(kind: str, param: float) -> tuple:
    """QSGD's ``(levels, 1 / levels)`` as the kernel takes them (zeros for
    the other kinds)."""
    levels = float(int(param)) if kind == "qsgd" else 0.0
    if kind == "qsgd" and levels < 1:
        raise ValueError(f"qsgd needs at least one level, got {param}")
    # torch's CUDA division by a Python scalar multiplies by its float32
    # reciprocal; the kernel does the same with this one
    inv_levels = float(np.float32(1.0) / np.float32(levels)) if levels else 0.0
    return levels, inv_levels


def _material_ptrs(mats: tuple) -> list:
    """The kernel's two material pointers (null where the kind takes fewer)."""
    return [m.data_ptr() for m in mats] + [0] * (2 - len(mats))


def client_sqnorms_cuda(updates: torch.Tensor) -> torch.Tensor:
    """(C, D) f32/bf16 -> (C,) f32 squared norms, in one launch.

    Any D and any start address of a contiguous matrix.  The kernel splits
    the clients into groups, each with a ticket counter of the current
    stream's (:func:`_counters`; at most C of them), whose last CTA finishes
    the group's norms.  CUDA tensors run the kernel (or raise); CPU tensors
    run the plain version.
    """
    if _on_cpu(updates):
        return client_sqnorms_ref(updates)
    c, d = _check(updates, any_width=True)
    dev = updates.device
    sq = torch.empty((c,), dtype=torch.float32, device=dev)
    if d == 0:
        return sq.zero_()
    partials = _scratch(c, d, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _kernel_fn("client_sqnorms", updates.dtype)(
        updates.data_ptr(), partials.data_ptr(), sq.data_ptr(),
        _counters(dev, stream, c).data_ptr(), c, d, _vector(d, updates), stream,
    )
    _raise_on(rc, "client_sqnorms")
    client_sqnorms_cuda.launches += 1
    return sq


def norm_scale_aggregate_cuda(updates: torch.Tensor, scale: torch.Tensor):
    """(C, D) f32/bf16, (C,) f32 -> ((C,) f32 squared norms, (D,) f32
    ``sum_i scale_i * U_i``) from one read of U, in one launch.

    Any D and any start address of a contiguous matrix.  The launch uses the
    current stream's ticket counter (:func:`_counters`): a call on another
    stream gets its own and gives the same result.  CUDA tensors run the
    kernel (or raise); CPU tensors run the plain version.
    """
    if _on_cpu(updates, scale):
        return norm_scale_aggregate_ref(updates, scale)
    c, d = _check(updates, scale, any_width=True)
    dev = updates.device
    sq = torch.empty((c,), dtype=torch.float32, device=dev)
    agg = torch.empty((d,), dtype=torch.float32, device=dev)
    if d == 0:
        return sq.zero_(), agg
    partials = _scratch(c, d, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _kernel_fn("norm_scale_aggregate", updates.dtype)(
        updates.data_ptr(), scale.data_ptr(), partials.data_ptr(), sq.data_ptr(),
        agg.data_ptr(), _counters(dev, stream).data_ptr(), c, d, _vector(d, updates), stream,
    )
    _raise_on(rc, "norm_scale_aggregate")
    norm_scale_aggregate_cuda.launches += 1
    return sq, agg


def compress_norm_scale_aggregate_cuda(updates: torch.Tensor, scale: torch.Tensor,
                                       mats: tuple, kind: str, param: float):
    """Raw (C, D) f32/bf16 + ``MATERIAL_ARITY[kind]`` (C, D) f32 material,
    (C,) f32 scale -> ((C,) f32 squared norms of C(U), (D,) f32
    ``sum_i scale_i * C(U_i)``), compressed in the tile stream, in one launch.

    Any D and any start addresses of contiguous matrices; the current
    stream's ticket counter, as :func:`norm_scale_aggregate_cuda`.  CUDA
    tensors run the kernel (or raise); CPU tensors run the plain version.
    """
    mats = _check_compressor(kind, mats)
    if _on_cpu(updates, scale, *mats):
        return compress_norm_scale_aggregate_ref(updates, scale, mats, kind, param)
    c, d = _check(updates, scale, mats, any_width=True)
    dev = updates.device
    sq = torch.empty((c,), dtype=torch.float32, device=dev)
    agg = torch.empty((d,), dtype=torch.float32, device=dev)
    if d == 0:
        return sq.zero_(), agg
    levels, inv_levels = _levels(kind, param)
    ptrs = _material_ptrs(mats)
    partials = _scratch(c, d, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _kernel_fn("compress_norm_scale_aggregate", updates.dtype)(
        updates.data_ptr(), scale.data_ptr(), ptrs[0], ptrs[1], partials.data_ptr(),
        sq.data_ptr(), agg.data_ptr(), _counters(dev, stream).data_ptr(), c, d,
        _vector(d, updates, *mats), KINDS[kind], levels, inv_levels, stream,
    )
    _raise_on(rc, "compress_norm_scale_aggregate")
    compress_norm_scale_aggregate_cuda.launches += 1
    return sq, agg


client_sqnorms_cuda.launches = 0
norm_scale_aggregate_cuda.launches = 0
compress_norm_scale_aggregate_cuda.launches = 0
