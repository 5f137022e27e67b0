"""Serving example on the PyTorch port (``repro_torch``; the counterpart of
``examples/serve_decode.py``): batched prefill + greedy decode across
architecture families (dense GQA, MoE+SWA ring cache, SSM O(1) state,
hybrid, enc-dec, VLM prefix).

  PYTHONPATH=src python examples/torch/serve_decode.py               # on the GPU
  PYTHONPATH=src python examples/torch/serve_decode.py --device cpu
"""

import argparse
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get
from repro_torch.kernels.ops import tree_leaves
from repro_torch.models import build_model

ARCHS = ["llama3-8b", "mixtral-8x7b", "mamba2-130m", "zamba2-2.7b",
         "whisper-small", "paligemma-3b"]


def main(argv=None):
    ap = argparse.ArgumentParser(description="prefill + greedy decode of six reduced families")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    out = {}
    for name in ARCHS:
        cfg = get(name + "-reduced")
        model = build_model(cfg)
        params = model.init(torch.Generator(device=device).manual_seed(0), device)
        b, s, gen = 2, 24, 8
        cache_len = s + gen
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s))}
        if cfg.encoder_seq:
            batch["frames"] = (rng.normal(size=(b, cfg.encoder_seq, cfg.d_model))
                               * 0.02).astype(np.float32)
        if cfg.prefix_tokens:
            batch["patches"] = (rng.normal(size=(b, cfg.prefix_tokens, cfg.d_model))
                                * 0.02).astype(np.float32)
        batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}

        t0 = time.perf_counter()
        with torch.inference_mode():
            logits, cache = model.prefill(params, batch, cache_len)
            tok = torch.argmax(logits[:, -1], -1)[:, None]
            toks = [tok]
            prefix = cfg.prefix_tokens or 0
            for i in range(gen - 1):
                logits, cache = model.decode_step(params, tok, cache, s + prefix + i)
                tok = torch.argmax(logits[:, -1], -1)[:, None]
                toks.append(tok)
        res = torch.cat(toks, 1).cpu().numpy()          # waits for the device
        cache_elems = sum(x.numel() for x in tree_leaves(cache))
        out[name] = res
        print(f"{name:18s} [{cfg.family:6s}] generated {res.shape} "
              f"cache={cache_elems/1e3:.0f}K elems  ({time.perf_counter()-t0:.1f}s)")
    return out


if __name__ == "__main__":
    main()
