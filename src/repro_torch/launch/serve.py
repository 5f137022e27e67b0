"""Serving driver: batched prefill + greedy decode — the port of
``repro/launch/serve.py`` for the families the port builds (ssm: mamba2;
hybrid: zamba2).  It follows the reference's steps: prompt tokens from
``np.random.default_rng(0)``, ``cache_len = prompt_len + gen``, greedy
argmax, decode position ``prompt_len + prefix + i``.

On the card the prefill of a long prompt runs the hand-written kernels: the
SSD scan in every Mamba2 block, and flash attention in the hybrid's shared
attention block at ``prompt_len >= CHUNK_THRESHOLD``.  Decode is eager.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b-reduced \\
      --batch 4 --prompt-len 32 --gen 16 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
      --batch 2 --prompt-len 4096 --gen 32            # on the GPU

``--restore`` and ``--metrics-port`` raise ``NotImplementedError``: the
checkpoint and observability modules are not ported yet.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get
from repro_torch.configs.base import ModelConfig
from repro_torch.models import build_model


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def prompt_tokens(cfg: ModelConfig, batch: int, prompt_len: int) -> np.ndarray:
    """The reference's prompt: ``default_rng(0).integers(0, vocab, (B, S))``."""
    return np.random.default_rng(0).integers(0, cfg.vocab_size, (batch, prompt_len))


def serve(cfg: ModelConfig, batch: int, prompt_len: int, gen: int, *, device=None,
          params=None, seed: int = 0):
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens, then decode
    ``gen`` tokens greedily (the prefill's token and ``gen - 1`` decode
    steps).

    ``params`` defaults to a random init from ``torch.Generator`` seeded with
    ``seed`` on ``device`` (``None`` = CUDA).  Returns ``(tokens, timings)``:
    the ``(batch, gen)`` int64 numpy array of generated tokens, and a dict of
    ``init_ms``, ``prefill_ms`` (prefill and its argmax) and ``decode_ms``
    (all decode steps), each ending in a device sync, and ``decode_steps``.
    """
    dev = resolve_device(device)
    model = build_model(cfg)
    t0 = time.perf_counter()
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(seed), dev)
    _sync(dev)
    init_ms = (time.perf_counter() - t0) * 1e3
    cache_len = prompt_len + gen
    prefix = cfg.prefix_tokens or 0
    tokens = torch.as_tensor(prompt_tokens(cfg, batch, prompt_len), device=dev)
    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {"tokens": tokens}, cache_len)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        _sync(dev)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        out = [tok]
        t0 = time.perf_counter()
        for i in range(gen - 1):
            logits, cache = model.decode_step(params, tok, cache, prompt_len + prefix + i)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            out.append(tok)
        _sync(dev)
        decode_ms = (time.perf_counter() - t0) * 1e3
    toks = torch.cat(out, dim=1).cpu().numpy()
    return toks, {"init_ms": init_ms, "prefill_ms": prefill_ms, "decode_ms": decode_ms,
                  "decode_steps": gen - 1}


def main(argv=None):
    ap = argparse.ArgumentParser(description="batched prefill + greedy decode")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--restore", default=None, metavar="PATH",
                    help="serve params restored from a checkpoint (not ported yet: raises)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="live metrics endpoint (not ported yet: raises)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)
    if args.restore is not None:
        raise NotImplementedError("--restore needs the checkpoint module, which is not "
                                  "ported yet (ROADMAP queue 1, item 4)")
    if args.metrics_port is not None:
        raise NotImplementedError("--metrics-port needs the obs module, which is not "
                                  "ported yet (ROADMAP queue 1, item 4)")
    cfg = get(args.arch)
    b, s = args.batch, args.prompt_len
    toks, t = serve(cfg, b, s, args.gen, device=args.device)
    steps = t["decode_steps"]
    print(f"[serve] prefill {b}x{s} in {t['prefill_ms'] / 1e3:.2f}s")
    print(f"[serve] generated {steps} steps x {b} seqs in {t['decode_ms'] / 1e3:.2f}s "
          f"({steps * b / max(t['decode_ms'] / 1e3, 1e-9):.1f} tok/s)")
    print(f"[serve] sample token ids: {toks[0][:16].tolist()}")
    return toks


if __name__ == "__main__":
    main()
