"""Eq. 2 masked aggregate ``out = sum_i scale_i * U_i`` on the GPU.

The hand-written CUDA kernel ``csrc/masked_aggregate.cu`` replaces the TPU
kernel ``repro/kernels/masked_aggregate.py::masked_scale_aggregate_pallas``.
It streams the client-major ``(C, D)`` update matrix once, contracts the
client axis in f32 registers in a fixed order (deterministic, no atomics),
and writes the ``(D,)`` f32 aggregate.  On an H100 it is bound by device
memory — ``C*D*4`` bytes read, ``D*4`` written, 2.32 us at the main path's
(32, 58880) — so each thread keeps the loads of 32 clients in flight.

:func:`masked_scale_aggregate_cuda` launches the kernel for CUDA tensors and
raises on anything it cannot take; for CPU tensors it returns the plain
version :func:`masked_scale_aggregate_ref`.  Its ``launches`` attribute
counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

COLS_PER_THREAD = 4        # kCols in the source: one vector load per client
THREADS = 128              # kThreads in the source
TILE = COLS_PER_THREAD * THREADS
MAX_CLIENTS = 48 * 1024 // 4   # scale is staged in 48 KB of shared memory

_SYMBOLS = {
    torch.float32: "masked_scale_aggregate_f32",
    torch.bfloat16: "masked_scale_aggregate_bf16",
}


def masked_scale_aggregate_ref(updates: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(clients, D), (clients,) -> (D,) f32: sum_i scale_i * updates_i."""
    x = updates.to(torch.float32)
    return torch.sum(x * scale.to(torch.float32)[:, None], dim=0)


def _kernel_fn(dtype):
    fn = getattr(_build.load("masked_aggregate"), _SYMBOLS[dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(updates: torch.Tensor, scale: torch.Tensor) -> None:
    if updates.device.type != "cuda" or scale.device != updates.device:
        raise ValueError(
            f"updates and scale must lie on one CUDA device, got "
            f"{updates.device} and {scale.device}"
        )
    if updates.dtype not in _SYMBOLS:
        raise TypeError(f"updates must be float32 or bfloat16, got {updates.dtype}")
    if scale.dtype != torch.float32:
        raise TypeError(f"scale must be float32, got {scale.dtype}")
    if updates.dim() != 2 or scale.shape != (updates.shape[0],):
        raise ValueError(
            f"want updates (C, D) and scale (C,), got {tuple(updates.shape)} "
            f"and {tuple(scale.shape)}"
        )
    c, d = updates.shape
    if not (updates.is_contiguous() and scale.is_contiguous()):
        raise ValueError("updates and scale must be contiguous")
    if d % COLS_PER_THREAD or updates.data_ptr() % (COLS_PER_THREAD * updates.element_size()):
        raise ValueError(
            f"D must be a multiple of {COLS_PER_THREAD} on an aligned buffer "
            f"(ops.masked_scale_aggregate pads it), got D={d}"
        )
    if c > MAX_CLIENTS or d >= 2**31:
        raise ValueError(
            f"shape beyond the kernel's limits: C={c} (at most {MAX_CLIENTS}), "
            f"D={d} (below 2**31)"
        )


def masked_scale_aggregate_cuda(updates: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(C, D) f32/bf16, (C,) f32 -> (D,) f32 ``sum_i scale_i * U_i``.

    CUDA tensors run the kernel (or raise); CPU tensors run the plain version.
    """
    if updates.device.type == "cpu" and scale.device.type == "cpu":
        return masked_scale_aggregate_ref(updates, scale)
    _check(updates, scale)
    c, d = updates.shape
    out = torch.empty((d,), dtype=torch.float32, device=updates.device)
    if d == 0:
        return out
    stream = torch.cuda.current_stream(updates.device).cuda_stream
    rc = _kernel_fn(updates.dtype)(
        updates.data_ptr(), scale.data_ptr(), out.data_ptr(), c, d, stream
    )
    if rc != 0:
        raise RuntimeError(f"masked_scale_aggregate kernel launch failed: CUDA error {rc}")
    masked_scale_aggregate_cuda.launches += 1
    return out


masked_scale_aggregate_cuda.launches = 0
