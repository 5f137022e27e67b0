"""Layer bodies and the embedding/head — the port of
``repro/models/transformer.py`` with its names and parameter layout.
Stacked layers are one tensor per leaf with the layer on the leading axis
(:func:`_stacked`); the models loop over them in Python (:func:`layer`).
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import tree_map
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.layers import (
    _dense_init,
    apply_attention,
    apply_mlp,
    apply_norm,
    init_attention,
    init_mlp,
    init_norm,
)

def _stacked(n: int, init_fn):
    """``n`` draws of ``init_fn()`` stacked leaf by leaf on a leading axis."""
    def walk(nodes):
        if isinstance(nodes[0], dict):
            return {k: walk([t[k] for t in nodes]) for k in nodes[0]}
        return torch.stack(nodes)

    return walk([init_fn() for _ in range(n)])


def layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copy)."""
    return tree_map(lambda x: x[i], tree)


# ---------------------------------------------------------------------------
# layer bodies


def init_attn_block(gen: torch.Generator, cfg: ModelConfig, ff_kind: str, cross: bool = False):
    """An attention block with an MLP or (``ff_kind="moe"``) a
    mixture-of-experts feed-forward; ``cross=True`` adds the
    encoder-decoder family's cross-attention (``norm_x``, ``xattn``)."""
    dev = gen.device
    p = {
        "norm1": init_norm(cfg, cfg.d_model, dev),
        "attn": init_attention(gen, cfg),
        "norm2": init_norm(cfg, cfg.d_model, dev),
        "ff": M.init_moe(gen, cfg) if ff_kind == "moe" else init_mlp(gen, cfg),
    }
    if cross:
        p["norm_x"] = init_norm(cfg, cfg.d_model, dev)
        p["xattn"] = init_attention(gen, cfg, cross=True)
    return p


def attn_block(p, h, cfg: ModelConfig, *, positions, mask, ff_kind: str, cache=None,
               cache_index=None, cross_kv=None, cross_mask=None, chunked_info=None):
    """Self-attention, then (with ``cross_kv``, the encoder's per-layer K/V)
    cross-attention over the encoder's output without RoPE, then the
    feed-forward; each a pre-norm residual.  The cross-attention takes the
    dense ``cross_mask`` form at any length: ``chunked_info`` (the causal
    kernel's) applies to the self-attention alone."""
    a, new_cache = apply_attention(
        p["attn"], apply_norm(p["norm1"], h, cfg), cfg, positions=positions, mask=mask,
        cache=cache, cache_index=cache_index, chunked_info=chunked_info,
    )
    h = h + a
    if cross_kv is not None:
        xa, _ = apply_attention(p["xattn"], apply_norm(p["norm_x"], h, cfg), cfg,
                                positions=positions, mask=cross_mask, kv_override=cross_kv,
                                use_rope=False)
        h = h + xa
    hn = apply_norm(p["norm2"], h, cfg)
    if ff_kind == "moe":
        f, aux = M.apply_moe(p["ff"], hn, cfg)
    else:
        f, aux = apply_mlp(p["ff"], hn, cfg), torch.zeros((), device=h.device)
    return h + f, new_cache, aux


def init_mamba_block(gen: torch.Generator, cfg: ModelConfig):
    return {"norm": init_norm(cfg, cfg.d_model, gen.device), "mamba": S.init_mamba2(gen, cfg)}


def mamba_block(p, h, cfg: ModelConfig):
    y, state = S.apply_mamba2(p["mamba"], apply_norm(p["norm"], h, cfg), cfg)
    return h + y, state


def mamba_block_decode(p, h, state, cfg: ModelConfig):
    y, new_state = S.decode_mamba2(p["mamba"], apply_norm(p["norm"], h, cfg), state, cfg)
    return h + y, new_state


# ---------------------------------------------------------------------------
# embedding / head


def init_embed(gen: torch.Generator, cfg: ModelConfig):
    p = {"embedding": torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                                  device=gen.device) * 0.02,
         "final_norm": init_norm(cfg, cfg.d_model, gen.device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = _dense_init(gen, (cfg.d_model, cfg.vocab_size))
    return p


def embed_tokens(p, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = p["embedding"][tokens].to(getattr(torch, cfg.dtype))
    if cfg.scale_embeddings:
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype)
    return h


def lm_logits(p, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = apply_norm(p["final_norm"], h, cfg)
    w = p["lm_head"] if not cfg.tie_embeddings else p["embedding"].T.to(h.dtype)
    return h @ w
