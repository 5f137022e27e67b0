"""Mamba2 / SSD (state-space duality) block [arXiv:2405.21060] — the port of
``repro/models/ssm.py`` with its names and parameter layout.

Sequences are split into chunks of ``ssm_chunk``: within a chunk the
attention-like masked form, across chunks the carried ``(B, H, P, N)``
state.  The chunked core (:func:`ssd_chunked`) routes by device: a CUDA
tensor runs the hand-written SSD scan kernel (``kernels/ops.py::ssd_scan_heads``)
on the model's own views, a CPU tensor the reference's two
eager forms (:func:`ssd_chunked_eager`: one pass over chunks when there are
more than 64 of them, batched chunks otherwise).  The kernel has no
backward: a call that autograd would record
(:func:`~repro_torch.models.layers.autograd_records`) runs the eager forms
on either device, as the reference differentiates its jnp forms.  Decode is the one-token
recurrence, in eager torch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import BlockLoop, _dense_init, autograd_records, on_card


def dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    nheads = d_in // cfg.ssm_head_dim
    conv_dim = d_in + 2 * cfg.ssm_state
    return d_in, nheads, conv_dim


def init_mamba2(gen: torch.Generator, cfg: ModelConfig):
    d = cfg.d_model
    d_in, nheads, conv_dim = dims(cfg)
    n = cfg.ssm_state
    dev = gen.device
    return {
        "in_proj": _dense_init(gen, (d, 2 * d_in + 2 * n + nheads)),
        "conv_w": _dense_init(gen, (conv_dim, cfg.ssm_conv), in_axis=1),
        "conv_b": torch.zeros((conv_dim,), device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nheads, device=dev)),
        "D": torch.ones((nheads,), device=dev),
        "dt_bias": torch.log(torch.expm1(torch.full((nheads,), 0.01, device=dev))),
        "norm_scale": torch.ones((d_in,), device=dev),
        "out_proj": _dense_init(gen, (d_in, d)),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x: (B, S, C), w: (C, K)."""
    k = w.shape[-1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + pad[:, i:i + x.shape[1], :] * w[:, i]
    return out + b


def _split(zxbcdt: torch.Tensor, cfg: ModelConfig):
    d_in, nheads, _ = dims(cfg)
    n = cfg.ssm_state
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:d_in + d_in + 2 * n]
    dt = zxbcdt[..., -nheads:]
    return z, xbc, dt


def _split_xbc(xbc: torch.Tensor, cfg: ModelConfig):
    """The conv output's (x, B, C) along its last axis."""
    d_in, n = dims(cfg)[0], cfg.ssm_state
    return xbc[..., :d_in], xbc[..., d_in:d_in + n], xbc[..., d_in + n:]


def _mean_square(y: torch.Tensor) -> torch.Tensor:
    return y.square().mean(-1, keepdim=True)


def _gated_norm(y, z, scale, eps=1e-6):
    y = y * F.silu(z.float())
    return y * torch.rsqrt(_mean_square(y) + eps) * scale


def ssd_chunked(xs, bmat, cmat, dt, da, chunk: int) -> tuple:
    """The chunked SSD core.  xs (B,S,H,P) and bmat, cmat (B,S,N) in the
    model's dtype, dt and da (B,S,H) f32, S a multiple of ``chunk`` ->
    (y (B,S,H,P) f32, final state (B,H,P,N) f32).  On a CUDA tensor the SSD
    scan kernel (:func:`ssd_scan_heads`); on a CPU tensor, a fake or
    distributed one (:func:`~repro_torch.models.layers.on_card`), or when
    autograd records the call, :func:`ssd_chunked_eager`."""
    if on_card(xs) and not autograd_records(xs, bmat, cmat, dt, da):
        return ssd_scan_heads(xs, bmat, cmat, dt, da, chunk)
    return ssd_chunked_eager(xs, bmat, cmat, dt, da, chunk)


def ssd_scan_heads(xs, bmat, cmat, dt, da, chunk: int) -> tuple:
    """The chunked SSD core through ``ops.ssd_scan_heads``: the kernel reads
    xs (B,S,H,P) and the one B/C group, as (B,S,1,N) views, in place, with dt
    and da per head, and writes y in the model's (B,S,H,P) layout: no
    per-head copy of B or C and no permute of x or y."""
    return ops.ssd_scan_heads(xs, bmat.unsqueeze(2), cmat.unsqueeze(2), dt, da, chunk=chunk)


def ssd_chunked_eager(xs, bmat, cmat, dt, da, chunk: int) -> tuple:
    """The reference's chunked SSD core in eager torch, both of its forms:
    more than 64 chunks run one fused pass over the chunks (live memory
    O(B Q Q H)), fewer run all chunks at once and then the inter-chunk
    recurrence.  Same arguments and results as :func:`ssd_chunked`.

    The decay masks the segment sums before ``exp`` (the reference masks
    after it): the values are the same, but above the diagonal a segment sum
    can pass float32's ``exp`` range at full width, and there the
    reference's gradient is ``0 * inf = nan`` where this one is 0."""
    bsz, seq, h, p = xs.shape
    n, q = bmat.shape[-1], chunk
    nc = seq // q
    xs_c = xs.reshape(bsz, nc, q, h, p).float()
    b_c = bmat.reshape(bsz, nc, q, n).float()
    c_c = cmat.reshape(bsz, nc, q, n).float()
    dt_c = dt.reshape(bsz, nc, q, h)
    da_c = da.reshape(bsz, nc, q, h)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xs.device))

    if nc > 64:
        state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=xs.device)
        ys = []
        loop = BlockLoop(nc, xs, bmat, cmat, dt, da)
        for ci in loop:
            x_i, b_i, c_i = xs_c[:, ci], b_c[:, ci], c_c[:, ci]
            dt_i, da_i = dt_c[:, ci], da_c[:, ci]
            a_cs = torch.cumsum(da_i, dim=1)                           # (B,Q,H)
            seg = a_cs[:, :, None, :] - a_cs[:, None, :, :]            # (B,Q,Q,H)
            decay = torch.exp(torch.where(tri[None, :, :, None], seg, -torch.inf))
            cb = torch.einsum("bsn,btn->bst", c_i, b_i)
            att = cb[..., None] * decay * dt_i[:, None, :, :]
            y_diag = torch.einsum("bsth,bthp->bshp", att, x_i)
            y_off = torch.einsum("btn,bth,bhpn->bthp", c_i, torch.exp(a_cs), state)
            a_tot = a_cs[:, -1, :]
            decay_out = torch.exp(a_tot[:, None, :] - a_cs)
            s_chunk = torch.einsum("bth,btn,bthp->bhpn", decay_out * dt_i, b_i, x_i)
            state = state * torch.exp(a_tot)[:, :, None, None] + s_chunk
            ys.append(y_diag + y_off)
        return torch.stack(loop.fill(ys), dim=1).reshape(bsz, seq, h, p), state

    a_cs = torch.cumsum(da_c, dim=2)                                   # (B,NC,Q,H)
    seg = a_cs[:, :, :, None, :] - a_cs[:, :, None, :, :]              # (B,NC,Q,Q,H)
    decay = torch.exp(torch.where(tri[None, None, :, :, None], seg, -torch.inf))
    cb = torch.einsum("bcsn,bctn->bcst", c_c, b_c)                     # (B,NC,Q,Q)
    att = cb[..., None] * decay * dt_c[:, :, None, :, :]               # (B,NC,Q,Q,H)
    y_diag = torch.einsum("bcsth,bcthp->bcshp", att, xs_c)
    a_tot = a_cs[:, :, -1, :]                                          # (B,NC,H)
    decay_out = torch.exp(a_tot[:, :, None, :] - a_cs)                 # (B,NC,Q,H)
    s_chunk = torch.einsum("bcth,bctn,bcthp->bchpn", decay_out * dt_c, b_c, xs_c)
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=xs.device)
    states_in = []
    loop = BlockLoop(nc, xs, bmat, cmat, dt, da)
    for ci in loop:                    # the state *entering* each chunk
        states_in.append(state)
        state = state * torch.exp(a_tot[:, ci])[:, :, None, None] + s_chunk[:, ci]
    states_in = torch.stack(loop.fill(states_in), dim=1)               # (B,NC,H,P,N)
    y_off = torch.einsum("bctn,bcth,bchpn->bcthp", c_c, torch.exp(a_cs), states_in)
    return (y_diag + y_off).reshape(bsz, seq, h, p), state


def _conv_state(xbc_pre: torch.Tensor, true_seq: int, width: int) -> torch.Tensor:
    """The last ``width`` pre-conv inputs before ``true_seq`` — the
    reference's ``dynamic_slice_in_dim``, whose start wraps when negative and
    then clamps into range (so a prompt shorter than ``width`` takes the
    padded tail, as in the reference).  A copy: a view would keep the whole
    input projection of the layer alive in the cache."""
    size = xbc_pre.shape[1]
    start = true_seq - width
    if start < 0:
        start += size
    start = max(0, min(start, size - width))
    return xbc_pre[:, start:start + width].clone()


def apply_mamba2(params, x: torch.Tensor, cfg: ModelConfig) -> tuple:
    """Training/prefill forward.  x: (B, S, d) -> (y, final_state), with
    final_state = (ssm_state (B,H,P,N), conv_state (B, K-1, conv_dim))."""
    bsz, true_seq, _ = x.shape
    d_in, nheads, _ = dims(cfg)
    p, q = cfg.ssm_head_dim, cfg.ssm_chunk
    # pad to a chunk multiple; padded steps get dt = 0 (identity recurrence)
    pad = (-true_seq) % q
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    seq = true_seq + pad

    zxbcdt = x @ params["in_proj"]
    z, xbc_pre, dt = _split(zxbcdt, cfg)
    xbc = F.silu(_causal_conv(xbc_pre, params["conv_w"], params["conv_b"]))
    xs, bmat, cmat = _split_xbc(xbc, cfg)                               # bmat, cmat (B,S,N)
    xs = xs.reshape(bsz, seq, nheads, p)

    dt = F.softplus(dt.float() + params["dt_bias"])                     # (B,S,H)
    if pad:
        valid = (torch.arange(seq, device=x.device) < true_seq)[None, :, None]
        dt = torch.where(valid, dt, 0.0)
    a = -torch.exp(params["A_log"].float())                             # (H,)
    da = dt * a                                                         # (B,S,H)

    y, final_state = ssd_chunked(xs, bmat, cmat, dt, da, q)
    y = y + params["D"][None, None, :, None] * xs.float()
    y = y.reshape(bsz, seq, d_in)
    y = _gated_norm(y, z, params["norm_scale"])
    out = (y @ params["out_proj"].float()).to(x.dtype)
    if pad:
        out = out[:, :true_seq]
    return out, (final_state, _conv_state(xbc_pre, true_seq, cfg.ssm_conv - 1))


def init_state(cfg: ModelConfig, batch: int, device=None):
    _, nheads, conv_dim = dims(cfg)
    return (
        torch.zeros((batch, nheads, cfg.ssm_head_dim, cfg.ssm_state), device=device),
        torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), device=device),
    )


def decode_mamba2(params, x: torch.Tensor, state, cfg: ModelConfig) -> tuple:
    """Single-token decode.  x: (B, 1, d), state from init_state/apply."""
    bsz = x.shape[0]
    d_in, nheads, _ = dims(cfg)
    p = cfg.ssm_head_dim
    ssm_state, conv_state = state

    zxbcdt = x[:, 0, :] @ params["in_proj"]                             # (B, ...)
    z, xbc_pre, dt = _split(zxbcdt, cfg)
    # conv over the buffered window, in the promoted dtype (as jnp's concatenate)
    wdtype = torch.promote_types(conv_state.dtype, xbc_pre.dtype)
    window = torch.cat([conv_state.to(wdtype), xbc_pre[:, None, :].to(wdtype)], dim=1)
    cdtype = torch.promote_types(wdtype, params["conv_w"].dtype)
    conv_out = torch.einsum("bkc,ck->bc", window.to(cdtype), params["conv_w"].to(cdtype))
    xbc = F.silu(conv_out + params["conv_b"])
    xt, bt, ct = _split_xbc(xbc, cfg)
    xt, bt, ct = xt.reshape(bsz, nheads, p).float(), bt.float(), ct.float()

    dt = F.softplus(dt.float() + params["dt_bias"])                     # (B,H)
    a = -torch.exp(params["A_log"].float())
    decay = torch.exp(dt * a)                                           # (B,H)

    new_state = ssm_state * decay[:, :, None, None] + torch.einsum(
        "bh,bn,bhp->bhpn", dt, bt, xt)
    y = torch.einsum("bn,bhpn->bhp", ct, new_state)
    y = y + params["D"][None, :, None] * xt
    y = y.reshape(bsz, d_in)
    y = _gated_norm(y, z, params["norm_scale"])
    out = (y @ params["out_proj"].float()).to(x.dtype)
    new_conv = torch.cat([conv_state[:, 1:, :].to(wdtype), xbc_pre[:, None, :].to(wdtype)], dim=1)
    return out[:, None, :], (new_state, new_conv)
