"""Causal flash attention, with an optional sliding window and an optional
bidirectional prefix, on the GPU.

The hand-written CUDA kernel ``csrc/flash_attention.cu`` replaces the TPU
kernel ``repro/kernels/flash_attention.py::flash_attention_pallas``: one CTA
per (row of ``BH``, 64-query tile) walks the key tiles that its mask does
not hide wholly, carries the online softmax ``(m, l, acc)`` in registers and
writes its tile once.  On an H100 it is bound by operations (two products of
``S^2 d`` per row, half of them hidden by the causal mask); this first
kernel does them in f32 FMAs.

:func:`flash_attention_cuda` launches the kernel for CUDA tensors and raises
on anything it cannot take; for CPU tensors it returns the plain version
:func:`flash_attention_ref`, which builds the whole ``(S, S)`` matrix.  Its
``launches`` attribute counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (32, 64, 80, 128, 256)     # the template instances in the source
MAX_ROWS = 65535                       # gridDim.y
NEG = torch.finfo(torch.float32).min   # the reference's mask value, not -inf

_SYMBOLS = {
    torch.float32: "flash_attention_f32",
    torch.bfloat16: "flash_attention_bf16",
}


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        window=None, prefix: int = 0) -> torch.Tensor:
    """(BH, S, d) x3 -> (BH, S, d) in q's dtype: softmax over the full masked
    ``(S, S)`` logits, in f32.  The mask is causal, ``& (i - j) < window``,
    then ``| prefix`` block — the reference's order."""
    s, d = q.shape[1], q.shape[2]
    logits = torch.einsum("bsd,btd->bst", q.float(), k.float())
    logits = logits / torch.sqrt(torch.tensor(float(d)))
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    mask = j <= i
    if window is not None:
        mask &= (i - j) < window
    if prefix:
        mask |= (i < prefix) & (j < prefix)
    logits = torch.where(mask[None], logits, NEG)
    probs = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = probs / probs.sum(-1, keepdim=True)
    return torch.einsum("bst,btd->bsd", probs, v.float()).to(q.dtype)


def _kernel_fn(dtype):
    fn = getattr(_build.load("flash_attention"), _SYMBOLS[dtype])
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float]
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, window, prefix) -> None:
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(
            f"q, k, v must lie on one CUDA device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _SYMBOLS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"q, k, v must share a dtype of float32 or bfloat16, got {q.dtype}, "
            f"{k.dtype}, {v.dtype}")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"want q, k, v of one shape (BH, S, d), got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}")
    bh, s, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not one the kernel takes {HEAD_DIMS}")
    if bh > MAX_ROWS or bh * s * d >= 2**62:
        raise ValueError(f"BH={bh} beyond the kernel's {MAX_ROWS} rows")
    for t in (q, k, v):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("q, k, v must be contiguous on 16-byte aligned buffers")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if prefix < 0:
        raise ValueError(f"prefix must be >= 0, got {prefix}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         window=None, prefix: int = 0) -> torch.Tensor:
    """(BH, S, d) f32/bf16 x3 -> (BH, S, d) in q's dtype: causal attention
    with scale ``1/sqrt(d)``, optional window and prefix (kv head-repeated).

    CUDA tensors run the kernel (or raise); CPU tensors run the plain version.
    """
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return flash_attention_ref(q, k, v, window=window, prefix=prefix)
    _check(q, k, v, window, prefix)
    bh, s, d = q.shape
    out = torch.empty_like(q)
    if bh == 0 or s == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _kernel_fn(q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, s, d,
        -1 if window is None else int(window), int(prefix), 1.0 / math.sqrt(d), stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {rc}")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
