"""Cache layouts for serving — the port of ``repro/models/kvcache.py``:

* ``kv``  : (num_layers, B, T, kv_heads, head_dim) x2 — full or ring buffer
            (T = the sliding window for SWA architectures);
* ``ssm`` : (num_mamba_layers, B, H, P, N) states + conv buffers — O(1) in S;
* ``cross``: (num_layers, B, encoder_seq, kv_heads, head_dim) x2 — whisper's
             encoder K/V, computed once at prefill.

Plain dicts of tensors, as the reference's pytrees.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm as S


def kv_buffer_len(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(cfg.sliding_window, seq_len)
    return seq_len


def init_kv(cfg: ModelConfig, n_layers: int, batch: int, seq_len: int, dtype, device=None):
    t = kv_buffer_len(cfg, seq_len)
    shape = (n_layers, batch, t, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_cross(cfg: ModelConfig, n_layers: int, batch: int, dtype, device=None):
    shape = (n_layers, batch, cfg.encoder_seq, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_ssm(cfg: ModelConfig, n_layers: int, batch: int, device=None):
    _, nheads, conv_dim = S.dims(cfg)
    return {
        "state": torch.zeros((n_layers, batch, nheads, cfg.ssm_head_dim, cfg.ssm_state),
                             device=device),
        "conv": torch.zeros((n_layers, batch, cfg.ssm_conv - 1, conv_dim), device=device),
    }
