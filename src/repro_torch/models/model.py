"""Public model API — the port of ``repro/models/model.py``:
``build_model(cfg)`` returns a :class:`Model` with

  init(gen, device)                        -> params
  forward(params, batch)                   -> (logits, aux)   # full sequence
  loss(params, batch)                      -> (scalar, metrics)
  prefill(params, batch, cache_len)        -> (last_logits, cache)
  decode_step(params, tokens, cache, pos)  -> (logits, cache)
  init_cache(batch_size, cache_len, device) -> cache

``batch`` is a dict with ``tokens`` (and ``targets`` for the loss), (B, S)
integers, and the stub modality inputs: for a VLM prefix (paligemma) the
embeddings ``patches`` (B, prefix_tokens, d), for whisper the audio frames'
embeddings ``frames`` (B, encoder_seq, d).  The port builds every family of
the reference: the decoder family (dense, MoE with an optional sliding
window, VLM prefix), the ``ssm`` family (mamba2), the ``hybrid`` family
(zamba2: a Mamba2 backbone with one weight-shared attention block every
``shared_attn_every`` layers) and the encoder-decoder family (whisper: a
bidirectional encoder over ``frames``, a causal decoder with
cross-attention).  Stacked layers are looped over in Python.  The
encoder-decoder family rematerialises each encoder layer and each decoder
layer of ``forward`` when autograd records it (:func:`~repro_torch.models.
layers.remat`, the reference's ``remat=True``): its dense encoder scores
would not fit in the card's memory for the vmap engine's 8 clients
otherwise.  The other families keep every activation.

``init`` draws from a ``torch.Generator`` (on its own device) and places the
parameters on ``device`` cast to ``cfg.dtype``, as the reference's ``_cast``
does; the decoder casts each layer as it is drawn, so a full-width init
never holds the whole stack in f32.  ``decode_step`` writes the step into
``cache`` in place and returns it (the reference returns an updated copy).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import tree_leaves, tree_rebuild
from repro_torch.models import kvcache as KV
from repro_torch.models import transformer as T
from repro_torch.models.layers import (
    apply_norm,
    causal_mask,
    decode_mask,
    init_norm,
    remat,
    sinusoidal_positions,
)

# sequences at/above this length use the chunked (flash-style) attention path
# and never materialise an (S, S) mask or score matrix
CHUNK_THRESHOLD = 2048


def _cast(tree, dtype, device):
    """f32 leaves to ``dtype``, every leaf to ``device`` (the reference's
    ``_cast``, with the placement)."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype, device) for k, v in tree.items()}
    leaf = tree.to(device)
    return leaf.to(dtype) if leaf.dtype == torch.float32 else leaf


def cross_entropy(logits, targets, mask=None):
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, targets[..., None].long(), dim=-1)[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _attn_ctx(cfg: ModelConfig, seq: int, prefix: int = 0, device=None):
    """(mask, chunked_info) for causal self-attention over ``seq`` tokens."""
    if seq >= CHUNK_THRESHOLD:
        return None, (cfg.sliding_window, prefix)
    return causal_mask(seq, cfg.sliding_window, prefix, device), None


def _positions(bsz: int, seq: int, device) -> torch.Tensor:
    return torch.arange(seq, device=device).expand(bsz, seq)


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable
    forward: Callable
    loss: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable


def _ce_loss(forward):
    def loss(p, batch):
        logits, _ = forward(p, batch)
        ce = cross_entropy(logits, batch["targets"], batch.get("loss_mask"))
        return ce, {"ce": ce, "aux": torch.zeros((), device=ce.device)}

    return loss


def _fit_kv(k: torch.Tensor, seq: int, buf_len: int) -> torch.Tensor:
    """The last ``buf_len`` of ``seq`` keys, ring-aligned, or the keys padded
    to ``buf_len`` (the reference's prefill placement)."""
    if seq >= buf_len:
        shift = (seq - buf_len) % buf_len
        return torch.roll(k[:, -buf_len:], shift, dims=1)
    return torch.nn.functional.pad(k, (0, 0, 0, 0, 0, buf_len - seq))


# ---------------------------------------------------------------------------
# decoder-only family (dense / moe / vlm prefix)


def _build_decoder(cfg: ModelConfig) -> Model:
    ff_kind = "moe" if cfg.layer_kinds()[0] == "attn_moe" else "mlp"
    nl = cfg.num_layers
    dtype = getattr(torch, cfg.dtype)

    def init(gen: torch.Generator, device=None):
        dev = device if device is not None else gen.device
        embed = _cast(T.init_embed(gen, cfg), dtype, dev)
        layers = T._stacked(nl, lambda: _cast(T.init_attn_block(gen, cfg, ff_kind), dtype, dev))
        return {"embed": embed, "layers": layers}

    def _inputs(p, batch):
        h = T.embed_tokens(p["embed"], batch["tokens"], cfg)
        prefix = 0
        if cfg.prefix_tokens:
            patches = batch["patches"].to(h.dtype)          # stub embeddings (B, P, d)
            h = torch.cat([patches, h], dim=1)
            prefix = cfg.prefix_tokens
        bsz, seq, _ = h.shape
        return h, _positions(bsz, seq, h.device), prefix

    def forward(p, batch):
        h, positions, prefix = _inputs(p, batch)
        mask, ci = _attn_ctx(cfg, h.shape[1], prefix if cfg.prefix_lm else 0, h.device)
        auxes = []
        for i in range(nl):
            h, _, aux = T.attn_block(T.layer(p["layers"], i), h, cfg, positions=positions,
                                     mask=mask, ff_kind=ff_kind, chunked_info=ci)
            auxes.append(aux)
        logits = T.lm_logits(p["embed"], h, cfg)
        if prefix:
            logits = logits[:, prefix:]
        return logits, torch.sum(torch.stack(auxes))

    def loss(p, batch):
        logits, aux = forward(p, batch)
        ce = cross_entropy(logits, batch["targets"], batch.get("loss_mask"))
        return ce + cfg.router_aux_coef * aux, {"ce": ce, "aux": aux}

    def init_cache(batch_size, cache_len, device=None):
        return {"kv": KV.init_kv(cfg, nl, batch_size, cache_len + (cfg.prefix_tokens or 0),
                                 dtype, device)}

    def prefill(p, batch, cache_len):
        h, positions, prefix = _inputs(p, batch)
        seq = h.shape[1]
        mask, ci = _attn_ctx(cfg, seq, prefix if cfg.prefix_lm else 0, h.device)
        cache = init_cache(h.shape[0], cache_len, h.device)
        k_all, v_all = cache["kv"]["k"], cache["kv"]["v"]
        buf_len = k_all.shape[2]
        for i in range(nl):
            h, (k, v), _ = T.attn_block(T.layer(p["layers"], i), h, cfg, positions=positions,
                                        mask=mask, ff_kind=ff_kind, cache=(), chunked_info=ci)
            k_all[i] = _fit_kv(k, seq, buf_len)
            v_all[i] = _fit_kv(v, seq, buf_len)
        return T.lm_logits(p["embed"], h[:, -1:, :], cfg), cache

    def decode_step(p, tokens, cache, pos):
        """tokens: (B, 1); pos: the position of this token (0-based; it counts
        a VLM's prefix)."""
        h = T.embed_tokens(p["embed"], tokens, cfg)
        positions = torch.full((h.shape[0], 1), pos, dtype=torch.int64, device=h.device)
        k_all, v_all = cache["kv"]["k"], cache["kv"]["v"]
        mask = decode_mask(k_all.shape[2], pos, cfg.sliding_window, h.device)
        for i in range(nl):
            h, _, _ = T.attn_block(T.layer(p["layers"], i), h, cfg, positions=positions,
                                   mask=mask, ff_kind=ff_kind, cache=(k_all[i], v_all[i]),
                                   cache_index=pos)
        return T.lm_logits(p["embed"], h, cfg), cache

    return Model(cfg, init, forward, loss, prefill, decode_step, init_cache)


# ---------------------------------------------------------------------------
# ssm family (mamba2)


def _build_ssm(cfg: ModelConfig) -> Model:
    nl = cfg.num_layers
    dtype = getattr(torch, cfg.dtype)

    def init(gen: torch.Generator, device=None):
        p = {
            "embed": T.init_embed(gen, cfg),
            "layers": T._stacked(nl, lambda: T.init_mamba_block(gen, cfg)),
        }
        return _cast(p, dtype, device if device is not None else gen.device)

    def _layers(p, h, collect_state=False):
        states = []
        for i in range(nl):
            h, state = T.mamba_block(T.layer(p["layers"], i), h, cfg)
            if collect_state:
                states.append(state)
        return h, states

    def forward(p, batch):
        h = T.embed_tokens(p["embed"], batch["tokens"], cfg)
        h, _ = _layers(p, h)
        return T.lm_logits(p["embed"], h, cfg), torch.zeros((), device=h.device)

    def init_cache(batch_size, cache_len, device=None):
        return {"ssm": KV.init_ssm(cfg, nl, batch_size, device)}

    def prefill(p, batch, cache_len):
        h = T.embed_tokens(p["embed"], batch["tokens"], cfg)
        h, states = _layers(p, h, collect_state=True)
        logits = T.lm_logits(p["embed"], h[:, -1:, :], cfg)
        return logits, {"ssm": {"state": torch.stack([s for s, _ in states]),
                                "conv": torch.stack([c for _, c in states])}}

    def decode_step(p, tokens, cache, pos):
        h = T.embed_tokens(p["embed"], tokens, cfg)
        st, cv = cache["ssm"]["state"], cache["ssm"]["conv"]
        for i in range(nl):
            h, (st2, cv2) = T.mamba_block_decode(T.layer(p["layers"], i), h, (st[i], cv[i]), cfg)
            st[i].copy_(st2)
            cv[i].copy_(cv2)
        return T.lm_logits(p["embed"], h, cfg), cache

    return Model(cfg, init, forward, _ce_loss(forward), prefill, decode_step, init_cache)


# ---------------------------------------------------------------------------
# hybrid family (zamba2: mamba backbone + shared attention block)


def _build_hybrid(cfg: ModelConfig) -> Model:
    every = cfg.shared_attn_every
    if every < 2 or cfg.num_layers % every:
        raise ValueError(f"shared_attn_every={every} must be >= 2 and divide "
                         f"num_layers={cfg.num_layers}")
    n_cycles = cfg.num_layers // every
    per_cycle = every - 1          # mamba layers per cycle; the last slot is the shared attn
    n_mamba = n_cycles * per_cycle
    dtype = getattr(torch, cfg.dtype)

    def init(gen: torch.Generator, device=None):
        p = {
            "embed": T.init_embed(gen, cfg),
            "mamba": T._stacked(n_mamba, lambda: T.init_mamba_block(gen, cfg)),
            "shared_attn": T.init_attn_block(gen, cfg, "mlp"),
        }
        return _cast(p, dtype, device if device is not None else gen.device)

    def forward(p, batch):
        h = T.embed_tokens(p["embed"], batch["tokens"], cfg)
        bsz, seq, _ = h.shape
        positions = _positions(bsz, seq, h.device)
        mask, ci = _attn_ctx(cfg, seq, device=h.device)
        for c in range(n_cycles):
            for j in range(per_cycle):
                h, _ = T.mamba_block(T.layer(p["mamba"], c * per_cycle + j), h, cfg)
            h, _, _ = T.attn_block(p["shared_attn"], h, cfg, positions=positions, mask=mask,
                                   ff_kind="mlp", chunked_info=ci)
        return T.lm_logits(p["embed"], h, cfg), torch.zeros((), device=h.device)

    def init_cache(batch_size, cache_len, device=None):
        return {
            "ssm": KV.init_ssm(cfg, n_mamba, batch_size, device),
            "kv": KV.init_kv(cfg, n_cycles, batch_size, cache_len, dtype, device),
        }

    def prefill(p, batch, cache_len):
        h = T.embed_tokens(p["embed"], batch["tokens"], cfg)
        bsz, seq, _ = h.shape
        positions = _positions(bsz, seq, h.device)
        mask, ci = _attn_ctx(cfg, seq, device=h.device)
        buf_len = KV.kv_buffer_len(cfg, cache_len)
        states, ks, vs = [], [], []
        for c in range(n_cycles):
            for j in range(per_cycle):
                h, st = T.mamba_block(T.layer(p["mamba"], c * per_cycle + j), h, cfg)
                states.append(st)
            h, (k, v), _ = T.attn_block(p["shared_attn"], h, cfg, positions=positions,
                                        mask=mask, ff_kind="mlp", cache=(), chunked_info=ci)
            ks.append(_fit_kv(k, seq, buf_len).to(dtype))
            vs.append(_fit_kv(v, seq, buf_len).to(dtype))
        logits = T.lm_logits(p["embed"], h[:, -1:, :], cfg)
        return logits, {
            "ssm": {"state": torch.stack([s for s, _ in states]),
                    "conv": torch.stack([c for _, c in states])},
            "kv": {"k": torch.stack(ks), "v": torch.stack(vs)},
        }

    def decode_step(p, tokens, cache, pos):
        h = T.embed_tokens(p["embed"], tokens, cfg)
        bsz = h.shape[0]
        positions = torch.full((bsz, 1), pos, dtype=torch.int64, device=h.device)
        k_all, v_all = cache["kv"]["k"], cache["kv"]["v"]
        mask = decode_mask(k_all.shape[2], pos, cfg.sliding_window, h.device)
        st, cv = cache["ssm"]["state"], cache["ssm"]["conv"]
        for c in range(n_cycles):
            for j in range(per_cycle):
                i = c * per_cycle + j
                h, (st2, cv2) = T.mamba_block_decode(T.layer(p["mamba"], i), h,
                                                     (st[i], cv[i]), cfg)
                st[i].copy_(st2)
                cv[i].copy_(cv2)
            h, _, _ = T.attn_block(p["shared_attn"], h, cfg, positions=positions, mask=mask,
                                   ff_kind="mlp", cache=(k_all[c], v_all[c]), cache_index=pos)
        return T.lm_logits(p["embed"], h, cfg), cache

    return Model(cfg, init, forward, _ce_loss(forward), prefill, decode_step, init_cache)


# ---------------------------------------------------------------------------
# encoder-decoder family (whisper)


def _remat_layer(body, h, lp, *extra):
    """``body(h, lp, *extra)`` through :func:`remat`, with the layer's
    parameter tree ``lp`` passed as its leaves so that they get gradients."""
    leaves = tree_leaves(lp)
    n = len(leaves)

    def fn(h, *ts):
        return body(h, tree_rebuild(lp, iter(ts[:n])), *ts[n:])

    return remat(fn, h, *leaves, *extra)


def _build_encdec(cfg: ModelConfig) -> Model:
    nl, ne = cfg.num_layers, cfg.encoder_layers
    dtype = getattr(torch, cfg.dtype)

    def init(gen: torch.Generator, device=None):
        dev = device if device is not None else gen.device

        def block(cross):
            return _cast(T.init_attn_block(gen, cfg, "mlp", cross=cross), dtype, dev)

        return {
            "embed": _cast(T.init_embed(gen, cfg), dtype, dev),
            "enc_layers": T._stacked(ne, lambda: block(False)),
            "dec_layers": T._stacked(nl, lambda: block(True)),
            "enc_final_norm": _cast(init_norm(cfg, cfg.d_model, gen.device), dtype, dev),
        }

    def encode(p, frames):
        """frames: (B, encoder_seq, d) stub embeddings (the conv front end is
        the reference's carve-out).  Bidirectional: the dense masked form at
        any length, so no kernel runs here."""
        bsz, es, _ = frames.shape
        h = frames.to(dtype) + sinusoidal_positions(es, cfg.d_model, frames.device).to(dtype)

        def body(h, lp):
            # the constants are made inside: a remat body closes over no tensor
            positions = _positions(bsz, es, h.device)
            mask = torch.ones((1, 1, es, es), dtype=torch.bool, device=h.device)
            return T.attn_block(lp, h, cfg, positions=positions, mask=mask, ff_kind="mlp")[0]

        for i in range(ne):
            h = _remat_layer(body, h, T.layer(p["enc_layers"], i))
        return apply_norm(p["enc_final_norm"], h, cfg)

    def _cross_kv(p, enc_out):
        """Every decoder layer's cross K/V of the encoder's output: two lists
        of L tensors (B, ES, kv_heads, head_dim)."""
        b, es, _ = enc_out.shape
        shape = (b, es, cfg.num_kv_heads, cfg.resolved_head_dim)
        xp = p["dec_layers"]["xattn"]
        return ([(enc_out @ xp["wk"][i]).reshape(shape) for i in range(nl)],
                [(enc_out @ xp["wv"][i]).reshape(shape) for i in range(nl)])

    def _dec_inputs(p, tokens):
        h = T.embed_tokens(p["embed"], tokens, cfg)
        return h + sinusoidal_positions(h.shape[1], cfg.d_model, h.device).to(h.dtype)

    def _dec_kw(h, es):
        """A decoder layer's constants over ``h``'s (B, S) and ``es`` frames."""
        bsz, seq, _ = h.shape
        mask, ci = _attn_ctx(cfg, seq, device=h.device)
        cmask = torch.ones((1, 1, seq, es), dtype=torch.bool, device=h.device)
        return {"positions": _positions(bsz, seq, h.device), "mask": mask, "ff_kind": "mlp",
                "cross_mask": cmask, "chunked_info": ci}

    def _decoder_ctx(p, batch):
        ck, cv = _cross_kv(p, encode(p, batch["frames"]))
        return _dec_inputs(p, batch["tokens"]), ck, cv

    def forward(p, batch):
        h, ck, cv = _decoder_ctx(p, batch)

        def body(h, lp, k, v):
            return T.attn_block(lp, h, cfg, cross_kv=(k, v), **_dec_kw(h, k.shape[1]))[0]

        for i in range(nl):
            h = _remat_layer(body, h, T.layer(p["dec_layers"], i), ck[i], cv[i])
        return T.lm_logits(p["embed"], h, cfg), torch.zeros((), device=h.device)

    def init_cache(batch_size, cache_len, device=None):
        return {"kv": KV.init_kv(cfg, nl, batch_size, cache_len, dtype, device),
                "cross": KV.init_cross(cfg, nl, batch_size, dtype, device)}

    def prefill(p, batch, cache_len):
        h, ck, cv = _decoder_ctx(p, batch)
        bsz, seq, _ = h.shape
        kw = _dec_kw(h, ck[0].shape[1])
        # the self K/V padded to cache_len (the reference keeps all seq keys
        # when the prompt is longer)
        kv = KV.init_kv(cfg, nl, bsz, max(cache_len, seq), dtype, h.device)
        for i in range(nl):
            h, (k, v), _ = T.attn_block(T.layer(p["dec_layers"], i), h, cfg, cache=(),
                                        cross_kv=(ck[i], cv[i]), **kw)
            kv["k"][i, :, :seq] = k
            kv["v"][i, :, :seq] = v
        logits = T.lm_logits(p["embed"], h[:, -1:, :], cfg)
        return logits, {"kv": kv, "cross": {"k": torch.stack(ck), "v": torch.stack(cv)}}

    tables = {}

    def decode_step(p, tokens, cache, pos):
        h = T.embed_tokens(p["embed"], tokens, cfg)
        k_all, v_all = cache["kv"]["k"], cache["kv"]["v"]
        t = k_all.shape[2]
        key = (t, h.device, h.dtype)
        if key not in tables:         # the position table, made once per cache length
            tables.clear()
            tables[key] = sinusoidal_positions(t, cfg.d_model, h.device).to(h.dtype)
        h = h + tables[key][pos]
        positions = torch.full((h.shape[0], 1), pos, dtype=torch.int64, device=h.device)
        mask = decode_mask(t, pos, None, h.device)
        ck, cv = cache["cross"]["k"], cache["cross"]["v"]
        cmask = torch.ones((1, 1, 1, ck.shape[2]), dtype=torch.bool, device=h.device)
        for i in range(nl):
            h, _, _ = T.attn_block(T.layer(p["dec_layers"], i), h, cfg, positions=positions,
                                   mask=mask, ff_kind="mlp", cache=(k_all[i], v_all[i]),
                                   cache_index=pos, cross_kv=(ck[i], cv[i]), cross_mask=cmask)
        return T.lm_logits(p["embed"], h, cfg), cache

    return Model(cfg, init, forward, _ce_loss(forward), prefill, decode_step, init_cache)


def build_model(cfg: ModelConfig) -> Model:
    kinds = set(cfg.layer_kinds())
    if cfg.encoder_layers:
        return _build_encdec(cfg)
    if kinds == {"mamba2"}:
        return _build_ssm(cfg)
    if "mamba2" in kinds:
        return _build_hybrid(cfg)
    return _build_decoder(cfg)
