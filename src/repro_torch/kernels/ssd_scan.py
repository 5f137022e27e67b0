"""The chunked SSD scan of Mamba2 on the GPU: a decayed causal attention
inside each chunk plus the ``(P, N)`` state carried across chunks.

The hand-written CUDA kernel ``csrc/ssd_scan.cu`` replaces the TPU kernel
``repro/kernels/ssd_scan.py::ssd_scan_pallas``: one CTA per row of ``BH``
walks its chunks in order with the f32 state in shared memory, and writes
``y`` once per chunk and the final state once.  On an H100 it is bound by
its f32 operations, and at one CTA per row it under-fills the card when BH
is small.

:func:`ssd_scan_cuda` launches the kernel for CUDA tensors and raises on
anything it cannot take; for CPU tensors it returns the plain version
:func:`ssd_scan_ref`, the reference's sequential recurrence (a loop over S).
Its ``launches`` attribute counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_SMEM_BYTES = 232448            # an H100 block's dynamic shared memory
ROW_BLOCK = 64                     # kRowBlock in the source

_SYMBOLS = {torch.float32: "ssd_scan_f32", torch.bfloat16: "ssd_scan_bf16"}


def smem_bytes(p: int, n: int, q: int) -> int:
    """The kernel's shared memory at head dim P, state N and chunk Q
    (``smem_floats`` in the source, times 4 bytes)."""
    rb = min(q, ROW_BLOCK)
    return 4 * (n * p + 2 * n * q + q * p + rb * q + 4 * q)


def ssd_scan_ref(x, b, c, dt, da) -> tuple:
    """Sequential SSD recurrence.  x (BH,S,P), b and c (BH,S,N), dt and da
    (BH,S) -> (y (BH,S,P) f32, final state (BH,P,N) f32)."""
    bh, s, p = x.shape
    n = b.shape[-1]
    x, b, c, dt, da = (t.float() for t in (x, b, c, dt, da))
    state = torch.zeros((bh, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        state = (state * torch.exp(da[:, t])[:, None, None]
                 + dt[:, t, None, None] * (x[:, t, :, None] * b[:, t, None, :]))
        ys.append(torch.einsum("bpn,bn->bp", state, c[:, t]))
    y = torch.stack(ys, dim=1) if ys else torch.zeros((bh, 0, p), device=x.device)
    return y, state


def _kernel_fn(dtype):
    fn = getattr(_build.load("ssd_scan"), _SYMBOLS[dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(x, b, c, dt, da, chunk) -> None:
    tensors = (x, b, c, dt, da)
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError(f"x, b, c, dt, da must lie on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if x.dtype not in _SYMBOLS or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"x, b, c must share a dtype of float32 or bfloat16, got "
                        f"{x.dtype}, {b.dtype}, {c.dtype}")
    if dt.dtype != torch.float32 or da.dtype != torch.float32:
        raise TypeError(f"dt and da must be float32, got {dt.dtype}, {da.dtype}")
    if x.dim() != 3 or b.dim() != 3:
        raise ValueError(f"want x (BH, S, P) and b, c (BH, S, N), got {tuple(x.shape)}, "
                         f"{tuple(b.shape)}")
    bh, s, p = x.shape
    n = b.shape[2]
    if c.shape != b.shape or b.shape[:2] != (bh, s) or dt.shape != (bh, s) or da.shape != (bh, s):
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, b {tuple(b.shape)}, c "
                         f"{tuple(c.shape)}, dt {tuple(dt.shape)}, da {tuple(da.shape)}")
    if chunk < 4 or chunk % 4 or p % 4 or n % 4 or s % chunk:
        raise ValueError(f"want chunk, P and N multiples of 4 and S a multiple of chunk "
                         f"(ops.ssd_scan pads S), got chunk={chunk}, P={p}, N={n}, S={s}")
    if smem_bytes(p, n, chunk) > MAX_SMEM_BYTES:
        raise ValueError(f"P={p}, N={n}, chunk={chunk} need {smem_bytes(p, n, chunk)} "
                         f"bytes of shared memory, beyond {MAX_SMEM_BYTES}")
    if bh >= 2**31 or bh * s * max(p, n) >= 2**62:
        raise ValueError(f"BH={bh} beyond the kernel's grid")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("x, b, c, dt, da must be contiguous on 16-byte aligned buffers")


def ssd_scan_cuda(x, b, c, dt, da, *, chunk: int = 128) -> tuple:
    """x (BH,S,P), b and c (BH,S,N) f32/bf16, dt and da (BH,S) f32, S a chunk
    multiple -> (y (BH,S,P) f32, final state (BH,P,N) f32).

    CUDA tensors run the kernel (or raise); CPU tensors run the plain version.
    """
    if all(t.device.type == "cpu" for t in (x, b, c, dt, da)):
        return ssd_scan_ref(x, b, c, dt, da)
    _check(x, b, c, dt, da, chunk)
    bh, s, p = x.shape
    n = b.shape[2]
    y = torch.empty((bh, s, p), dtype=torch.float32, device=x.device)
    state = torch.zeros((bh, p, n), dtype=torch.float32, device=x.device)
    if bh == 0 or s == 0:
        return y, state
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _kernel_fn(x.dtype)(
        x.data_ptr(), b.data_ptr(), c.data_ptr(), dt.data_ptr(), da.data_ptr(),
        y.data_ptr(), state.data_ptr(), bh, s, p, n, chunk, stream,
    )
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {rc}")
    ssd_scan_cuda.launches += 1
    return y, state


ssd_scan_cuda.launches = 0
