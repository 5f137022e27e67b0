"""The chunked SSD scan of Mamba2 on the GPU: a decayed causal attention
inside each chunk plus the ``(P, N)`` state carried across chunks.

The hand-written CUDA kernel ``csrc/ssd_scan.cu`` replaces the TPU kernel
``repro/kernels/ssd_scan.py::ssd_scan_pallas`` with three chunk-parallel
passes: the chunk states (grid over chunk, batch and head group), the
serial state passing over the chunks (grid over batch x head and the
state's elements), and the chunk outputs (chunk, batch, head group), with
the states in an f32 scratch ``(B, NC, H, P, N)`` that the wrapper
allocates.  bf16 runs every product on the tensor cores and computes
``C B^T`` once per chunk for a group of heads; float32 runs scalar FMAs.
On an H100 it is bound by device memory.

The kernel takes the model's views: x ``(B, S, H, P)``, B and C
``(B, S, G, N)`` with ``G`` 1 or ``H``, dt and da ``(B, S, H)``, with element
strides (P and N contiguous).  :func:`ssd_scan_heads_cuda` is that entry;
:func:`ssd_scan_cuda` keeps the reference's per-row ``(BH, S, P)`` interface
(contiguous rows), the case ``H = G = 1``.  Both launch the kernel for CUDA
tensors and raise on anything it cannot take; for CPU tensors they return
the plain version, the reference's sequential recurrence (a loop over S).
``ssd_scan_cuda.launches`` counts the kernel's launches through either.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

MAX_SMEM_BYTES = 232448            # an H100 block's dynamic shared memory
PAD = 8                            # kPad in the source
ROW_BLOCK = 64                     # kRowBlock in the source
MAX_CHUNK_BF16 = 128               # kMaxQ
MAX_HEAD_DIM_BF16 = 64             # kMaxP
MAX_HEADS_PER_CTA = 8

_SYMBOLS = {torch.float32: "ssd_scan_f32", torch.bfloat16: "ssd_scan_bf16"}


def smem_bytes(p: int, n: int, q: int, dtype=torch.float32) -> int:
    """The kernel's shared memory at head dim P, state N and chunk Q: the
    larger of its chunk-state and chunk-output passes (``smem_*`` in the
    source; the bf16 chunk-state pass at MAX_HEADS_PER_CTA heads)."""
    if dtype == torch.bfloat16:
        state = 2 * q * (n + PAD) + 4 * q * (p + PAD) + 8 * MAX_HEADS_PER_CTA * q
        out = 4 * q * (n + PAD) + 2 * (4 * p * (n + PAD) + 2 * q * (p + PAD) + 8 * q)
    else:
        rb = min(q, ROW_BLOCK)
        state = 4 * (n * q + q * p + 3 * q)
        out = 4 * (n * p + 2 * n * q + q * p + rb * q + 3 * q)
    return max(state, out)


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


def ssd_scan_heads_ref(x, b, c, dt, da) -> tuple:
    """The sequential recurrence on the model's layout: x (B,S,H,P), b and c
    (B,S,G,N) with G 1 or H, dt and da (B,S,H) -> (y (B,S,H,P) f32, final
    state (B,H,P,N) f32)."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]

    def rows(t):
        return t.expand(bsz, s, h, t.shape[-1]).permute(0, 2, 1, 3).reshape(bsz * h, s, -1)

    def per_head(t):
        return t.permute(0, 2, 1).reshape(bsz * h, s)

    y, state = ssd_scan_ref(rows(x), rows(b), rows(c), per_head(dt), per_head(da))
    return (y.reshape(bsz, h, s, p).permute(0, 2, 1, 3).contiguous(),
            state.reshape(bsz, h, p, n))


def _kernel_fn(dtype):
    fn = getattr(_build.load("ssd_scan"), _SYMBOLS[dtype])
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.POINTER(ctypes.c_longlong)]
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _strides(t: torch.Tensor) -> list:
    """The (batch, sequence, head) element strides of a 4-D (or the three of
    a 3-D) tensor; 0 along a dim of size 1, which the kernel never steps (so
    a (B, S, 1, N) group of B or C serves every head)."""
    return [st if size > 1 else 0 for size, st in zip(t.shape[:3], t.stride()[:3])]


def _check_layout(x, b, c, dt, da, chunk) -> None:
    """What the kernel takes of the views, wherever they lie: dtypes, the
    shapes (B,S,H,P), (B,S,G,N) with G 1 or H, (B,S,H); S a multiple of the
    chunk; Q and P multiples of 16 and N of 8 (bf16: Q <= 128, P <= 64); the
    shared memory; x, B, C with a contiguous last axis, on 16-byte aligned
    pointers with (batch, sequence, head) strides of whole 16 bytes."""
    if x.dtype not in _SYMBOLS or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"x, b, c must share a dtype of float32 or bfloat16, got "
                        f"{x.dtype}, {b.dtype}, {c.dtype}")
    if dt.dtype != torch.float32 or da.dtype != torch.float32:
        raise TypeError(f"dt and da must be float32, got {dt.dtype}, {da.dtype}")
    if x.dim() != 4 or b.dim() != 4 or dt.dim() != 3:
        raise ValueError(f"want x (B, S, H, P), b and c (B, S, G, N), dt and da (B, S, H), "
                         f"got {tuple(x.shape)}, {tuple(b.shape)}, {tuple(dt.shape)}")
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if (c.shape != b.shape or b.shape[:2] != (bsz, s) or g not in (1, h)
            or dt.shape != (bsz, s, h) or da.shape != (bsz, s, h)):
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, b {tuple(b.shape)}, c "
                         f"{tuple(c.shape)}, dt {tuple(dt.shape)}, da {tuple(da.shape)} "
                         f"(G must be 1 or H)")
    if chunk < 16 or chunk % 16 or p % 16 or n % 8 or s % chunk:
        raise ValueError(f"want chunk and P multiples of 16, N of 8 and S a multiple of chunk "
                         f"(ops.ssd_scan pads S), got chunk={chunk}, P={p}, N={n}, S={s}")
    if x.dtype == torch.bfloat16 and (chunk > MAX_CHUNK_BF16 or p > MAX_HEAD_DIM_BF16):
        raise ValueError(f"the bf16 kernel takes chunk <= {MAX_CHUNK_BF16} and P <= "
                         f"{MAX_HEAD_DIM_BF16}, got chunk={chunk}, P={p}")
    need = smem_bytes(p, n, chunk, x.dtype)
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"P={p}, N={n}, chunk={chunk} need {need} bytes of shared memory, "
                         f"beyond {MAX_SMEM_BYTES}")
    if bsz * (s // chunk) * h >= 2**31 or bsz * h * p * n >= 2**39:
        raise ValueError(f"(B, S, H) = {(bsz, s, h)} beyond the kernel's grid")
    align = 16 // x.element_size()
    for name, t in zip("xbc", (x, b, c)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s last stride must be 1, got {t.stride(3)}")
        if t.data_ptr() % 16 or any(st % align for st in _strides(t)):
            raise ValueError(
                f"{name} must start on a 16-byte boundary with (batch, sequence, head) strides "
                f"of whole 16 bytes ({align} elements), got strides {tuple(t.stride())}")


def _check_device(*tensors) -> None:
    x = tensors[0]
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError(f"x, b, c, dt, da must lie on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")


def _check(x, b, c, dt, da, chunk) -> None:
    """The per-row interface: contiguous (BH, S, P), (BH, S, N), (BH, S)."""
    tensors = (x, b, c, dt, da)
    _check_device(*tensors)
    if x.dim() != 3 or b.dim() != 3 or c.dim() != 3 or dt.dim() != 2 or da.dim() != 2:
        raise ValueError(f"want x (BH, S, P), b and c (BH, S, N), dt and da (BH, S), got "
                         f"{[tuple(t.shape) for t in tensors]}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("x, b, c, dt, da must be contiguous")
    _check_layout(*(t.unsqueeze(2) for t in tensors), chunk)


def heads_per_cta(nb: int, nc: int, h: int, g: int, dtype, sms: int) -> int:
    """Heads that one CTA of the chunk passes runs in turn, sharing its chunk's
    C B^T: 1 for float32, for G = H and for one head; else up to
    MAX_HEADS_PER_CTA, as many as leave at least 2.5 CTAs per SM, evened out
    over the groups (on an H100: 8 at zamba2-2.7b's prefill, 4 at
    mamba2-130m's, the fastest of 2, 4, 8, 10 and 16 at both)."""
    if dtype != torch.bfloat16 or g != 1 or h == 1:
        return 1
    hg = max(1, min(MAX_HEADS_PER_CTA, 2 * nb * nc * h // (5 * sms)))
    groups = -(-h // hg)
    return -(-h // groups)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(x, b, c, dt, da, chunk) -> tuple:
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    y = torch.empty((bsz, s, h, p), dtype=torch.float32, device=x.device)
    if bsz == 0 or s == 0 or h == 0:
        return y, torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    nc = s // chunk
    # the passes' scratch in one allocation: the chunk states (B, NC, H, P, N),
    # a_tot (B, NC, H) and aux (B, NC, H, 2, Q), each a multiple of 16 bytes
    units = bsz * nc * h
    work = torch.empty(units * (p * n + 4 + 2 * chunk), dtype=torch.float32, device=x.device)
    scratch, atot, aux = work.split([units * p * n, units * 4, units * 2 * chunk])
    hg = heads_per_cta(bsz, nc, h, g, x.dtype, _sm_count(x.device))
    strides = (ctypes.c_longlong * 15)(*(st for t in (x, b, c, dt, da) for st in _strides(t)))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _kernel_fn(x.dtype)(
        x.data_ptr(), b.data_ptr(), c.data_ptr(), dt.data_ptr(), da.data_ptr(),
        y.data_ptr(), state.data_ptr(), scratch.data_ptr(), atot.data_ptr(), aux.data_ptr(),
        strides,
        bsz, s, h, p, n, chunk, hg, stream,
    )
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {rc}")
    ssd_scan_cuda.launches += 1
    return y, state


def ssd_scan_heads_cuda(x, b, c, dt, da, *, chunk: int = 128) -> tuple:
    """x (B,S,H,P), b and c (B,S,G,N) with G 1 or H, f32/bf16 views with the
    last axis contiguous; dt and da (B,S,H) f32; S a chunk multiple -> (y
    (B,S,H,P) f32 contiguous, final state (B,H,P,N) f32).

    CUDA tensors run the kernel on the views in place (or raise); CPU tensors
    run the plain version.
    """
    if all(t.device.type == "cpu" for t in (x, b, c, dt, da)):
        return ssd_scan_heads_ref(x, b, c, dt, da)
    _check_device(x, b, c, dt, da)
    _check_layout(x, b, c, dt, da, chunk)
    return _launch(x, b, c, dt, da, chunk)


def ssd_scan_cuda(x, b, c, dt, da, *, chunk: int = 128) -> tuple:
    """x (BH,S,P), b and c (BH,S,N) f32/bf16, dt and da (BH,S) f32, all
    contiguous, S a chunk multiple -> (y (BH,S,P) f32, final state (BH,P,N) f32).

    CUDA tensors run the kernel (or raise); CPU tensors run the plain version.
    """
    if all(t.device.type == "cpu" for t in (x, b, c, dt, da)):
        return ssd_scan_ref(x, b, c, dt, da)
    _check(x, b, c, dt, da, chunk)
    y, state = _launch(*(t.unsqueeze(2) for t in (x, b, c, dt, da)), chunk)
    return y.view(x.shape[0], x.shape[1], x.shape[2]), state.view(x.shape[0], *state.shape[2:])


ssd_scan_cuda.launches = 0
