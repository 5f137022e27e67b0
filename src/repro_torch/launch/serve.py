"""Serving driver: batched prefill + greedy decode — the port of
``repro/launch/serve.py`` for every family (decoder: dense, MoE, VLM
prefix; ssm: mamba2; hybrid: zamba2; encoder-decoder: whisper).  It follows
the reference's steps: prompt tokens (then whisper's stub ``frames``, then a
VLM's stub ``patches``) from ``np.random.default_rng(0)``, ``cache_len =
prompt_len + gen``, greedy argmax, decode position ``prompt_len + prefix +
i``.  Status lines go through the obs logger (``[serve] ...``;
``REPRO_LOG=WARNING`` silences them).

On the card the prefill of a long prompt runs the hand-written kernels: the
SSD scan in every Mamba2 block, and flash attention (with the sliding window
or the bidirectional prefix where the config has one) in every causal
self-attention block at ``prompt_len >= CHUNK_THRESHOLD`` (whisper's
bidirectional encoder and its cross-attention stay dense).  Decode is eager.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b-reduced \\
      --batch 4 --prompt-len 32 --gen 16 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
      --batch 2 --prompt-len 4096 --gen 32            # on the GPU

``--restore PATH`` serves parameters from a checkpoint instead of a random
init (:func:`load_params`: the ``['params']`` subtree of a round
checkpoint, or a params-only checkpoint whole; either package's, bf16 bit
for bit), and ``--metrics-port`` serves the ``prefill`` and ``decode``
spans' seconds as ``repro_phase_seconds`` (``repro_torch/obs/http.py``).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.checkpoint import restore, restore_subtree
from repro_torch.checkpoint.ckpt import _read_index, resolve_dir
from repro_torch.configs import get
from repro_torch.configs.base import ModelConfig
from repro_torch.models import build_model
from repro_torch.obs import MetricsServer, get_logger, span

log = get_logger("serve")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def load_params(path: str, like_params):
    """Model parameters out of any checkpoint under ``path``.

    A round checkpoint (the sim driver's, or the reference's training
    loop's) keeps them under ``['params']`` beside optimizer and client
    state: found from the saved keys and restored with
    :func:`~repro_torch.checkpoint.restore_subtree`; a params-only
    checkpoint restores whole.  Dtypes and shapes are checked against the
    template ``like_params`` (``ValueError`` naming the key), and each leaf
    lands on its template leaf's device.  Returns ``(params, step)``.
    """
    idx = _read_index(resolve_dir(path))
    if any(k.startswith("['params']") for k in idx["keys"]):
        return restore_subtree(path, like_params, "['params']")
    return restore(path, like_params)


def prompt_tokens(cfg: ModelConfig, batch: int, prompt_len: int) -> np.ndarray:
    """The reference's prompt: ``default_rng(0).integers(0, vocab, (B, S))``."""
    return prompt_batch(cfg, batch, prompt_len)["tokens"]


def prompt_batch(cfg: ModelConfig, batch: int, prompt_len: int) -> dict:
    """The reference's prefill batch as numpy arrays: the prompt tokens, then
    for whisper the stub ``frames`` ``(B, encoder_seq, d)`` and for a VLM
    prefix the stub ``patches`` ``(B, prefix_tokens, d)``, both f32, drawn in
    that order from the same ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, prompt_len))}
    if cfg.encoder_seq:
        out["frames"] = (rng.normal(size=(batch, cfg.encoder_seq, cfg.d_model))
                         * 0.02).astype(np.float32)
    if cfg.prefix_tokens:
        out["patches"] = (rng.normal(size=(batch, cfg.prefix_tokens, cfg.d_model))
                          * 0.02).astype(np.float32)
    return out


def serve(cfg: ModelConfig, batch: int, prompt_len: int, gen: int, *, device=None,
          params=None, seed: int = 0, sink=None):
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens, then decode
    ``gen`` tokens greedily (the prefill's token and ``gen - 1`` decode
    steps).

    ``params`` defaults to a random init from ``torch.Generator`` seeded with
    ``seed`` on ``device`` (``None`` = CUDA).  Returns ``(tokens, timings)``:
    the ``(batch, gen)`` int64 numpy array of generated tokens, and a dict of
    ``init_ms``, ``prefill_ms`` (prefill and its argmax) and ``decode_ms``
    (all decode steps), each ending in a device sync, and ``decode_steps``.
    Prefill and decode run in obs spans named ``prefill`` and ``decode``,
    whose seconds go to ``sink`` (anything with ``record_span``) when given.
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
    inputs = {k: torch.as_tensor(v, device=dev)
              for k, v in prompt_batch(cfg, batch, prompt_len).items()}
    with torch.inference_mode():
        with span("prefill", sink) as sp:
            logits, cache = model.prefill(params, inputs, cache_len)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            sp.block(tok)
        prefill_ms = sp.seconds * 1e3
        out = [tok]
        with span("decode", sink) as sp:
            for i in range(gen - 1):
                logits, cache = model.decode_step(params, tok, cache, prompt_len + prefix + i)
                tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
                out.append(tok)
            sp.block(tok)
        decode_ms = sp.seconds * 1e3
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
                    help="serve params restored from this checkpoint (root or "
                         "step-XXXXXXXX dir; round and params-only layouts both work) "
                         "instead of a random init")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve a live JSON/Prometheus metrics endpoint on this port "
                         "(0 = ephemeral)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)
    cfg = get(args.arch)
    server = sink = None
    if args.metrics_port is not None:
        server = MetricsServer(port=args.metrics_port).start()
        log.info("metrics endpoint at %s/metrics", server.url)
        phase_seconds = {}

        class _Sink:
            # fold each span into the endpoint's snapshot
            def record_span(self, name, seconds):
                phase_seconds[name] = seconds
                server.update({"run": {"arch": args.arch, "mode": "serve"},
                               "phase_seconds": dict(phase_seconds)})

        sink = _Sink()
    params = None
    if args.restore is not None:
        dev = resolve_device(args.device)
        like = build_model(cfg).init(torch.Generator(device=dev).manual_seed(0), dev)
        params, step = load_params(args.restore, like)
        log.info("restored params from %s (round %d)", args.restore, step)
    b, s = args.batch, args.prompt_len
    try:
        toks, t = serve(cfg, b, s, args.gen, device=args.device, params=params, sink=sink)
    finally:
        if server is not None:
            server.stop()
    steps = t["decode_steps"]
    log.info("prefill %dx%d in %.2fs", b, s, t["prefill_ms"] / 1e3)
    dt = t["decode_ms"] / 1e3
    log.info("generated %d steps x %d seqs in %.2fs (%.1f tok/s)", steps, b, dt,
             steps * b / max(dt, 1e-9))
    log.info("sample token ids: %s", toks[0][:16].tolist())
    return toks


if __name__ == "__main__":
    main()
