"""Causal flash attention, with an optional sliding window and an optional
bidirectional prefix, on the GPU.

The hand-written CUDA kernels in ``csrc/flash_attention.cu`` replace the TPU
kernel ``repro/kernels/flash_attention.py::flash_attention_pallas``: one CTA
per (batch, head, query tile) walks the key tiles that its mask does not
hide wholly, carries the online softmax ``(m, l, acc)`` in registers and
writes its tile once.  On an H100 it is bound by operations (two products of
``S^2 d`` per row, half of them hidden by the causal mask).  bf16 runs on the
tensor cores (``wgmma`` fed by TMA; P split into two bf16 halves for the
second product); float32 runs the scalar f32-FMA kernel, whose bounds TF32
could not meet.

Both take q, k, v as ``(B, S, H, d)`` views with element strides for batch,
sequence and head (d contiguous), so the model passes its projections with
no copies; a ``(BH, S, d)`` tensor is the case ``H = 1``.

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
MAX_GRID = 65535                       # gridDim.y (heads) and gridDim.z (batch)
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


def _heads(t: torch.Tensor) -> torch.Tensor:
    """A (BH, S, d) tensor as the (B, S, H, d) view with H = 1."""
    return t.unsqueeze(2) if t.dim() == 3 else t


def _strides(t: torch.Tensor) -> list:
    """The (batch, sequence, head) element strides of a (B, S, H, d) tensor;
    the kernel never steps along a dim of size 1, so its stride is given as d."""
    return [st if n > 1 else t.shape[3] for n, st in zip(t.shape[:3], t.stride()[:3])]


def _kernel_fn(dtype):
    fn = getattr(_build.load("flash_attention"), _SYMBOLS[dtype])
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 2
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_layout(q, k, v) -> None:
    """What the kernels take of q, k, v, wherever they lie: one dtype of
    float32 or bfloat16, one shape (BH, S, d) or (B, S, H, d) with d a
    template instance, d contiguous, and 16-byte aligned pointers and
    strides (TMA's rule for global strides)."""
    if q.dtype not in _SYMBOLS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"q, k, v must share a dtype of float32 or bfloat16, got {q.dtype}, "
            f"{k.dtype}, {v.dtype}")
    if q.dim() not in (3, 4) or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"want q, k, v of one shape (BH, S, d) or (B, S, H, d), got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = _heads(q).shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not one the kernel takes {HEAD_DIMS}")
    if b > MAX_GRID or h > MAX_GRID or s >= 2**31:
        raise ValueError(f"(B, S, H) = {(b, s, h)} beyond the kernel's grid "
                         f"(B, H <= {MAX_GRID}, S < 2**31)")
    align = 16 // q.element_size()
    for name, t in zip("qkv", (q, k, v)):
        t = _heads(t)
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s head-dim stride must be 1, got {t.stride(3)}")
        if t.data_ptr() % 16 or any(st % align for st in _strides(t)):
            raise ValueError(
                f"{name} must start on a 16-byte boundary with (batch, sequence, head) "
                f"strides of whole 16 bytes ({align} elements), got strides "
                f"{tuple(t.stride())}")


def _check(q, k, v, window, prefix) -> None:
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(
            f"q, k, v must lie on one CUDA device, got {q.device}, {k.device}, {v.device}")
    _check_layout(q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if prefix < 0:
        raise ValueError(f"prefix must be >= 0, got {prefix}")


def _heads_ref(q, k, v, window, prefix):
    """The plain version on (B, S, H, d): the (B*H, S, d) rows and back."""
    b, s, h, d = q.shape

    def rows(t):
        return t.permute(0, 2, 1, 3).reshape(b * h, s, d)

    out = flash_attention_ref(rows(q), rows(k), rows(v), window=window, prefix=prefix)
    return out.reshape(b, h, s, d).permute(0, 2, 1, 3).contiguous()


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         window=None, prefix: int = 0) -> torch.Tensor:
    """(BH, S, d) or (B, S, H, d) f32/bf16 x3 -> the same shape in q's dtype
    (contiguous): causal attention with scale ``1/sqrt(d)``, optional window
    and prefix (kv head-repeated).  q, k, v may be strided views.

    CUDA tensors run the kernel (or raise); CPU tensors run the plain version.
    """
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        if q.dim() == 3:
            return flash_attention_ref(q, k, v, window=window, prefix=prefix)
        return _heads_ref(q, k, v, window, prefix)
    _check(q, k, v, window, prefix)
    q4, k4, v4 = _heads(q), _heads(k), _heads(v)
    b, s, h, d = q4.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if out.numel():
        strides = (ctypes.c_longlong * 12)(*(x for t in (q4, k4, v4, out) for x in _strides(t)))
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _kernel_fn(q.dtype)(
            q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), out.data_ptr(), b, s, h, d, strides,
            -1 if window is None else int(window), int(prefix), 1.0 / math.sqrt(d), stream,
        )
        if rc != 0:
            raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {rc}")
        flash_attention_cuda.launches += 1
    return out.squeeze(2) if q.dim() == 3 else out


flash_attention_cuda.launches = 0
