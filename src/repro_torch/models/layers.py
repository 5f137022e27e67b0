"""Shared neural building blocks: norms, RoPE, attention (causal, sliding
window, prefix-LM, KV caches), gated MLPs — the port of
``repro/models/layers.py`` with its names and parameter layout (plain dicts
of tensors, the sharded dimension last), so converted reference parameters
drop in unchanged.

``init_*`` draw from an explicit ``torch.Generator`` on its own device;
``apply_*`` are plain functions of tensors.  ``chunked_attention`` routes by
device: a CUDA tensor runs the hand-written flash-attention kernel
(``kernels/ops.py::flash_attention``), a CPU tensor the reference's blocked
online-softmax algorithm in eager torch.  The kernels have no backward, as
in the reference, whose models never differentiate a Pallas kernel: a call
that autograd would record (:func:`autograd_records`) runs the eager form
on either device.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

NEG = torch.finfo(torch.float32).min

# ---------------------------------------------------------------------------
# initialisers


def _dense_init(gen: torch.Generator, shape, in_axis: int = 0) -> torch.Tensor:
    """Normal(0, 1/fan_in) in f32, drawn from ``gen`` on its device."""
    scale = 1.0 / math.sqrt(shape[in_axis])
    return torch.randn(shape, generator=gen, device=gen.device) * scale


# ---------------------------------------------------------------------------
# norms


def init_norm(cfg: ModelConfig, d: int, device=None):
    if cfg.norm_kind == "layernorm":
        return {"scale": torch.ones((d,), device=device),
                "bias": torch.zeros((d,), device=device)}
    fill = torch.zeros if cfg.norm_offset else torch.ones
    return {"scale": fill((d,), device=device)}


def apply_norm(params, x: torch.Tensor, cfg: ModelConfig, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if cfg.norm_kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + eps)
        out = out * params["scale"] + params["bias"]
    else:
        ms = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps)
        scale = params["scale"]
        out = out * (1.0 + scale) if cfg.norm_offset else out * scale
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd), positions: (..., S) integer."""
    half = x.shape[-1] // 2
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32))
    freqs = torch.exp(-log_theta * torch.arange(0, half, dtype=torch.float32) / half)
    angles = positions[..., None].float() * freqs.to(x.device)   # (..., S, half)
    angles = angles[..., None, :]                                  # broadcast over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d: int, device=None) -> torch.Tensor:
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(torch.tensor(10000.0, device=device), 2 * dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


# ---------------------------------------------------------------------------
# attention


def init_attention(gen: torch.Generator, cfg: ModelConfig, cross: bool = False):
    """The four projections; a cross-attention (``cross=True``, whisper's
    decoder) draws the same four, as the reference's does: its ``wk`` and
    ``wv`` project the encoder's output."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, k = cfg.num_heads, cfg.num_kv_heads
    return {
        "wq": _dense_init(gen, (d, h * hd)),
        "wk": _dense_init(gen, (d, k * hd)),
        "wv": _dense_init(gen, (d, k * hd)),
        "wo": _dense_init(gen, (h * hd, d)),
    }


def autograd_records(*tensors) -> bool:
    """True when autograd would record an op on ``tensors``: grad mode is
    on and one of them requires grad, or one is a ``torch.func`` wrapper
    (under ``grad``, ``vjp`` or ``vmap``).  The model routes such a call to
    the eager form, which is differentiable, and every other CUDA call to
    its kernel: ``no_grad`` and ``inference_mode`` (serving) launch it."""
    if _REMAT_FORWARDS[0]:
        return True
    wrapped = torch._C._functorch.is_functorch_wrapped_tensor
    if any(wrapped(t) for t in tensors):
        return True
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def on_card(t: torch.Tensor) -> bool:
    """True for a plain CUDA tensor, whose storage a kernel can read: not a
    tensor subclass such as a ``FakeTensor`` or a ``DTensor`` (the dry-run's
    stand-ins), which take the eager forms."""
    return t.is_cuda and type(t) in (torch.Tensor, torch.nn.Parameter)


# the dry-run (``launch/dryrun.py``) sets this to its counters' ``repeat(n)``,
# a context under which what they count is counted n times
_LOOP_COUNTER = [None]


class BlockLoop:
    """``range(n)`` over the iterations of an eager form's block loop, which
    all have the same shapes.  In a dry-run that counts work
    (``_LOOP_COUNTER`` set), where autograd records nothing, only the first
    iteration runs, counted n times; :meth:`fill` then repeats a list the
    loop collected to n entries, so that what follows sees the full run's
    shapes.  Otherwise it is ``range(n)``."""

    def __init__(self, n: int, *tensors: torch.Tensor):
        self.n = n
        self.repeat = _LOOP_COUNTER[0]
        if self.repeat is not None and autograd_records(*tensors):
            self.repeat = None

    def __iter__(self):
        if self.repeat is None or self.n == 0:
            yield from range(self.n)
            return
        with self.repeat(self.n):
            yield 0

    def fill(self, items: list) -> list:
        return items if self.repeat is None else items * self.n


# the depth of :class:`_Remat` forwards running: their ops are recorded again
# in the backward, so they take the eager forms the backward differentiates
_REMAT_FORWARDS = [0]


class _Remat(torch.autograd.Function):
    """``fn(*args)`` that keeps only ``args`` for the backward and runs ``fn``
    again there under ``torch.func.vjp``: the reference's ``jax.checkpoint``.
    It works under ``torch.func.grad`` and ``vmap`` (which refuse
    ``torch.utils.checkpoint``'s saved-tensor hooks) as under
    ``loss.backward()``."""

    generate_vmap_rule = True

    @staticmethod
    def forward(fn, *args):
        _REMAT_FORWARDS[0] += 1
        try:
            return fn(*args)
        finally:
            _REMAT_FORWARDS[0] -= 1

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.fn = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, grad):
        # torch.func.grad runs the backward with create_graph: a recompute on
        # the saved inputs as they are would be recorded at the outer level
        # too, which keeps every layer's activations until the gradient is
        # done.  Detached, under no_grad, only the inner vjp records.
        args = [t.detach() for t in ctx.saved_tensors]
        with torch.no_grad():
            _, pull = torch.func.vjp(ctx.fn, *args)
            return (None, *pull(grad))


def remat(fn, *args: torch.Tensor) -> torch.Tensor:
    """``fn(*args)``, rematerialised in the backward when autograd records
    the call (:func:`autograd_records`); else a plain call.  ``fn`` returns
    one tensor, and every tensor it differentiates through is in ``args``:
    what it closes over gets no gradient."""
    if not autograd_records(*args):
        return fn(*args)
    return _Remat.apply(fn, *args)


def _split_heads(x: torch.Tensor, n_heads: int, head_dim: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (n_heads, head_dim))


def _repeat_kv(kv: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return kv
    return torch.repeat_interleave(kv, n_rep, dim=-2)


def chunked_attention(q, k, v, *, window=None, prefix=0, block_q=512, block_k=512):
    """Causal attention with optional sliding window and bidirectional prefix
    that never materialises the (S, S) score matrix.

    q, k, v: (B, S, H, hd) with kv heads already repeated; returns
    (B, S, H, hd).  On a CUDA tensor it runs the flash-attention kernel
    (:func:`flash_attention_heads`, output in q's dtype); on a CPU tensor, a
    fake or distributed one (:func:`on_card`), or when autograd records the
    call (:func:`autograd_records`), the reference's blocked algorithm
    (:func:`chunked_attention_eager`, f32).
    """
    if on_card(q) and not autograd_records(q, k, v):
        return flash_attention_heads(q, k, v, window=window, prefix=prefix)
    return chunked_attention_eager(q, k, v, window=window, prefix=prefix,
                                   block_q=block_q, block_k=block_k)


def flash_attention_heads(q, k, v, *, window=None, prefix=0):
    """(B, S, H, hd) attention through ``ops.flash_attention``, which reads
    the views as they are given (strides for batch, sequence and head) and
    writes a contiguous ``(B, S, H, hd)`` output: no ``(B*H, S, hd)`` copies."""
    return ops.flash_attention(q, k, v, window=window, prefix=prefix)


def chunked_attention_eager(q, k, v, *, window=None, prefix=0, block_q=512, block_k=512):
    """The reference's flash-style attention in eager torch: query blocks, an
    inner loop over key blocks with online-softmax accumulators, masked with
    ``finfo(float32).min``.  (B, S, H, hd) -> (B, S, H, hd) f32."""
    b, s, h, hd = q.shape
    bq, bk = min(block_q, s), min(block_k, s)
    nq, nk = -(-s // bq), -(-s // bk)
    pad_q, pad_k = nq * bq - s, nk * bk - s
    qf = F.pad(q, (0, 0, 0, 0, 0, pad_q)).float()
    kf = F.pad(k, (0, 0, 0, 0, 0, pad_k)).float()
    vf = F.pad(v, (0, 0, 0, 0, 0, pad_k)).float()
    qf = qf.reshape(b, nq, bq, h, hd) / torch.sqrt(torch.tensor(float(hd)))
    kf = kf.reshape(b, nk, bk, h, hd)
    vf = vf.reshape(b, nk, bk, h, hd)
    dev = q.device
    outs = []
    q_loop = BlockLoop(nq, q, k, v)
    for qi in q_loop:
        q_i = qf[:, qi]
        q_pos = qi * bq + torch.arange(bq, device=dev)
        m = torch.full((b, h, bq), NEG, device=dev)
        l = torch.zeros((b, h, bq), device=dev)
        acc = torch.zeros((b, h, bq, hd), device=dev)
        for ki in BlockLoop(nk, q, k, v):
            k_pos = ki * bk + torch.arange(bk, device=dev)
            logits = torch.einsum("bshd,bthd->bhst", q_i, kf[:, ki])
            msk = k_pos[None, :] <= q_pos[:, None]
            if window is not None:
                msk &= (q_pos[:, None] - k_pos[None, :]) < window
            if prefix:
                msk |= (q_pos[:, None] < prefix) & (k_pos[None, :] < prefix)
            msk &= (k_pos[None, :] < s) & (q_pos[:, None] < s)
            logits = torch.where(msk[None, None], logits, NEG)
            m_new = torch.maximum(m, logits.amax(-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bhst,bthd->bhsd", p, vf[:, ki])
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 2, 1, 3))      # (b, bq, h, hd)
    return torch.cat(q_loop.fill(outs), dim=1)[:, :s]


def attention_scores(q, k, v, mask, dtype):
    """q: (B,S,H,hd) k,v: (B,T,H,hd) mask: broadcastable to (B,H,S,T).

    The reference keeps bf16 operands with f32 accumulation and f32 results;
    torch's bf16 products round their results to bf16, so both products take
    the operands upcast to f32 (exact) instead.
    """
    hd = q.shape[-1]
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float())
    logits = logits / torch.sqrt(torch.tensor(float(hd)))
    logits = torch.where(mask, logits, NEG)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs.to(v.dtype).float(), v.float())
    return out.to(dtype)


def causal_mask(seq: int, window=None, prefix: int = 0, device=None) -> torch.Tensor:
    """(1,1,S,S) bool mask: causal, optional sliding window, optional
    bidirectional prefix (prefix-LM)."""
    i = torch.arange(seq, device=device)[:, None]
    j = torch.arange(seq, device=device)[None, :]
    m = j <= i
    if window is not None:
        m &= (i - j) < window
    if prefix:
        m |= (i < prefix) & (j < prefix)
    return m[None, None]


def apply_attention(params, x, cfg: ModelConfig, *, positions=None, mask=None, cache=None,
                    cache_index=None, kv_override=None, use_rope=True, chunked_info=None):
    """Unified attention, as the reference's:

    * training / prefill: full sequence, ``mask`` (B,1|H,S,T) or (1,1,S,S),
      or ``chunked_info=(window, prefix)`` for :func:`chunked_attention`;
      returns ``(out, new_cache)``, ``new_cache = (k, v)`` when ``cache`` is
      given as an empty tuple (prefill), else None.
    * decode: ``x`` is (B,1,d), ``cache=(k_buf, v_buf)`` ring/linear
      buffers, ``cache_index`` the write position.  The step's keys and
      values are written into the buffers in place (the reference returns
      updated copies), and ``new_cache`` is the same buffers.
    * cross-attention: ``kv_override=(k, v)`` precomputed, cache-free.
    """
    hd = cfg.resolved_head_dim
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    n_rep = h // kvh
    bsz, s, _ = x.shape

    q = _split_heads(x @ params["wq"], h, hd)
    if kv_override is not None:
        k, v = kv_override
        new_cache = None
        if positions is not None and use_rope and cfg.positional == "rope":
            q = rope(q, positions, cfg.rope_theta)
    else:
        k = _split_heads(x @ params["wk"], kvh, hd)
        v = _split_heads(x @ params["wv"], kvh, hd)
        if use_rope and cfg.positional == "rope":
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        if cache is not None and cache_index is not None:
            k_buf, v_buf = cache
            slot = cache_index % k_buf.shape[1] if cfg.sliding_window else cache_index
            k_buf[:, slot:slot + s] = k.to(k_buf.dtype)
            v_buf[:, slot:slot + s] = v.to(v_buf.dtype)
            new_cache = (k_buf, v_buf)
            k, v = k_buf, v_buf
        elif cache is not None:
            new_cache = (k, v)
        else:
            new_cache = None

    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    if chunked_info is not None and s > 1:
        window, prefix = chunked_info
        out = chunked_attention(q, k, v, window=window, prefix=prefix).to(x.dtype)
    else:
        out = attention_scores(q, k, v, mask, x.dtype)
    out = out.reshape(bsz, s, h * hd) @ params["wo"]
    return out, new_cache


def decode_mask(cache_len: int, pos: int, window, device=None) -> torch.Tensor:
    """(1,1,1,T) mask for one decode step: valid cache slots only."""
    t = torch.arange(cache_len, device=device)
    if window is None:
        m = t <= pos
    else:
        # ring buffer of size cache_len == window: the slots written so far
        m = t < min(pos + 1, cache_len)
    return m[None, None, None, :]


# ---------------------------------------------------------------------------
# MLPs


def init_mlp(gen: torch.Generator, cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_kind in ("swiglu", "geglu"):
        return {
            "w_gate": _dense_init(gen, (d, f)),
            "w_up": _dense_init(gen, (d, f)),
            "w_down": _dense_init(gen, (f, d)),
        }
    return {
        "w_up": _dense_init(gen, (d, f)),
        "w_down": _dense_init(gen, (f, d)),
        "b_up": torch.zeros((f,), device=gen.device),
        "b_down": torch.zeros((d,), device=gen.device),
    }


def apply_mlp(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """jax.nn.gelu's default is the tanh approximation; so is this one's."""
    if cfg.mlp_kind == "swiglu":
        return (F.silu(x @ params["w_gate"]) * (x @ params["w_up"])) @ params["w_down"]
    if cfg.mlp_kind == "geglu":
        gate = F.gelu(x @ params["w_gate"], approximate="tanh")
        return (gate * (x @ params["w_up"])) @ params["w_down"]
    hid = F.gelu(x @ params["w_up"] + params["b_up"], approximate="tanh")
    return hid @ params["w_down"] + params["b_down"]
