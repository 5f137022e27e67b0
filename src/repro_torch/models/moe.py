"""Mixture-of-Experts feed-forward with GShard-style grouped dispatch — the
port of ``repro/models/moe.py`` with its names and parameter layout.

* Tokens are reshaped into groups of ``moe_group_size``, so the dispatch and
  combine one-hots are ``(G, Tg, E, C)`` with a small capacity ``C``, and
  dispatch and combine are products with them: no scatter, no ``index_add_``
  (which adds with atomics on CUDA), so a second run on the card is bitwise
  the first, and every expert slot holds at most one token.
* Capacity ``C = max(4, min(int(Tg k / E * capacity_factor) + 1, Tg))``;
  tokens beyond it are dropped (their expert output is 0).
* Top-k routing is an iterative argmax (k is 1 or 2 here), with per-slot
  positions from a cumulative count in token order, so slot-2 tokens take
  the capacity slot 1 left.

``cfg.moe_ep_axis`` is the reference's expert-parallel sharding hint; the
port runs the experts on one device and ignores it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _dense_init


def init_moe(gen: torch.Generator, cfg: ModelConfig):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": _dense_init(gen, (d, e)),
        "w_gate": _dense_init(gen, (e, d, f), in_axis=1),
        "w_up": _dense_init(gen, (e, d, f), in_axis=1),
        "w_down": _dense_init(gen, (e, f, d), in_axis=1),
    }


def _capacity(cfg: ModelConfig, tg: int) -> int:
    e, k = cfg.num_experts, cfg.num_experts_per_token
    c = int(tg * k / e * cfg.moe_capacity_factor) + 1
    return max(4, min(c, tg))


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """int64 one-hot of ``idx`` over ``n`` classes (``F.one_hot`` reads the
    indices' range back to the host, which ``torch.func.vmap`` refuses)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


def route(logits: torch.Tensor, cfg: ModelConfig) -> tuple:
    """Top-k routing with capacity.  logits: (G, Tg, E).

    Returns (dispatch (G,Tg,E,C) bool, combine (G,Tg,E,C) f32, aux_loss)."""
    g, tg, e = logits.shape
    k = cfg.num_experts_per_token
    c = _capacity(cfg, tg)
    dev = logits.device
    probs = torch.softmax(logits.float(), dim=-1)

    remaining = probs
    counts = torch.zeros((g, e), dtype=torch.int64, device=dev)
    dispatch = torch.zeros((g, tg, e, c), dtype=torch.bool, device=dev)
    combine = torch.zeros((g, tg, e, c), dtype=torch.float32, device=dev)
    gates_sum = torch.zeros((g, tg), dtype=torch.float32, device=dev)
    frac_routed = torch.zeros((g, e), dtype=torch.float32, device=dev)

    for _ in range(k):
        idx = torch.argmax(remaining, dim=-1)                        # (G,Tg)
        hot = _one_hot(idx, e)                                       # (G,Tg,E) int64
        onehot = hot.float()
        frac_routed = frac_routed + onehot.mean(dim=1)
        # position of each token within its expert for this slot (integers:
        # the reference's f32 cumsum is exact at these counts)
        pos = torch.cumsum(hot, dim=1) - hot + counts[:, None, :]
        pos_tok = (pos * hot).sum(dim=-1)                            # (G,Tg)
        keep = pos_tok < c
        counts = counts + hot.sum(dim=1)
        gate = (probs * onehot).sum(dim=-1)                          # (G,Tg)
        slot = _one_hot(torch.where(keep, pos_tok, c), c + 1)[..., :c].float()
        d_k = onehot[..., None] * slot[:, :, None, :]                # (G,Tg,E,C)
        dispatch = dispatch | (d_k > 0)
        combine = combine + gate[..., None, None] * d_k
        gates_sum = gates_sum + torch.where(keep, gate, 0.0)
        remaining = remaining * (1.0 - onehot)

    # renormalise the combine weights over the k selected experts
    # (mixtral-style); top-1 keeps the raw gate probability (switch-style),
    # so the router still receives gradient
    if k > 1:
        combine = combine / torch.clamp(gates_sum, min=1e-9)[..., None, None]

    # switch-style load balance aux loss
    mean_probs = probs.mean(dim=1)                                    # (G,E)
    aux = e * torch.mean(torch.sum(frac_routed / k * mean_probs, dim=-1))
    return dispatch, combine, aux


def apply_moe(params, x: torch.Tensor, cfg: ModelConfig) -> tuple:
    """x: (B, S, d) -> (B, S, d), plus the aux loss."""
    b, s, d = x.shape
    tokens = x.reshape(b * s, d)
    t = tokens.shape[0]
    tg = min(cfg.moe_group_size, t)
    g = -(-t // tg)
    pad = g * tg - t
    if pad:
        tokens = F.pad(tokens, (0, 0, 0, pad))
    grouped = tokens.reshape(g, tg, d)

    logits = grouped @ params["router"]                               # (G,Tg,E)
    dispatch, combine, aux = route(logits, cfg)
    e, c = dispatch.shape[2], dispatch.shape[3]

    # dispatch: (G, E*C, Tg) @ (G, Tg, d); each slot sums at most one token
    disp = dispatch.to(grouped.dtype).reshape(g, tg, e * c).transpose(1, 2)
    xe = (disp @ grouped).reshape(g, e, c, d).transpose(0, 1)        # (E,G,C,d)
    xe = xe.reshape(e, g * c, d)
    if cfg.mlp_kind in ("swiglu", "geglu"):
        h = xe @ params["w_gate"]                                     # (E,G*C,f)
        h = F.silu(h) if cfg.mlp_kind == "swiglu" else F.gelu(h, approximate="tanh")
        h = h * (xe @ params["w_up"])
    else:
        h = F.gelu(xe @ params["w_up"], approximate="tanh")
    ye = (h @ params["w_down"]).reshape(e, g, c, d).transpose(0, 1)   # (G,E,C,d)
    # combine: (G, Tg, E*C) @ (G, E*C, d)
    out = combine.to(ye.dtype).reshape(g, tg, e * c) @ ye.reshape(g, e * c, d)

    out = out.reshape(g * tg, d)
    if pad:
        out = out[:t]
    return out.reshape(b, s, d), aux
