"""Federated training of an assigned-architecture LLM with OCS on the
PyTorch port (``repro_torch``; the counterpart of
``examples/federated_llm.py``): one ``make_round`` step a round on a
reduced config (pass --arch llama3-8b for the full config on the GPU;
``--arch whisper-small-reduced`` draws the encoder's stub ``frames``).

  PYTHONPATH=src python examples/torch/federated_llm.py --arch llama3-8b-reduced \\
      --rounds 30 --clients 8 --m 2
  PYTHONPATH=src python examples/torch/federated_llm.py --arch whisper-small-reduced \\
      --rounds 5 --device cpu
"""

import argparse

import numpy as np
import torch

from repro_torch import rng as trng
from repro_torch._device import resolve_device, upload
from repro_torch.configs import get
from repro_torch.configs.base import FLConfig
from repro_torch.data import charlm
from repro_torch.fl.round import client_weights, make_round, round_bits
from repro_torch.kernels.ops import tree_leaves
from repro_torch.models import build_model


def main(argv=None):
    ap = argparse.ArgumentParser(description="federated training of a language model with OCS")
    ap.add_argument("--arch", default="llama3-8b-reduced")
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--m", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--sampler", default="aocs")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get(args.arch)
    # text data: per-client heterogeneous char streams re-tokenised to vocab
    ds = charlm(n_clients=max(24, args.clients * 3), seq_len=args.seq,
                chars_per_client=3000, seed=5)
    model = build_model(cfg)
    fl = FLConfig(n_clients=args.clients, expected_clients=args.m,
                  sampler=args.sampler, local_steps=2, lr_local=0.25)
    key = trng.PRNGKey(0, device)
    params = model.init(torch.Generator(device=device).manual_seed(0), device)
    dim = sum(leaf.numel() for leaf in tree_leaves(params))
    step = make_round(model.loss, fl, device=device)
    w = client_weights(fl, device=device)
    rng = np.random.default_rng(0)
    print(f"{cfg.name}: {dim/1e6:.2f}M params, vocab {cfg.vocab_size}, "
          f"n={fl.n_clients} m={fl.expected_clients} sampler={fl.sampler}")

    bits, rows = 0, []
    for k in range(args.rounds):
        clients = rng.choice(ds.n_clients, size=fl.n_clients, replace=False)
        raw = ds.sample_round_batches(rng, clients, fl.local_steps, args.batch)
        batch = {
            "tokens": raw["tokens"] % cfg.vocab_size,
            "targets": raw["targets"] % cfg.vocab_size,
            "_step_mask": raw["_step_mask"],
        }
        if cfg.encoder_seq:
            batch["frames"] = (rng.normal(size=(fl.n_clients, fl.local_steps, args.batch,
                                                cfg.encoder_seq, cfg.d_model))
                               * 0.02).astype(np.float32)
        if cfg.prefix_tokens:
            batch["patches"] = (rng.normal(size=(fl.n_clients, fl.local_steps, args.batch,
                                                 cfg.prefix_tokens, cfg.d_model))
                                * 0.02).astype(np.float32)
        batch = {name: upload(v, device) for name, v in batch.items()}
        params, _, m = step(params, (), batch, w, trng.fold_in(key, k))
        mask = m.mask.cpu().numpy()
        bits += round_bits(fl, dim, mask)
        rows.append({"loss": float(m.loss), "mask": mask, "sent": int(m.sent_clients)})
        if k % 5 == 0 or k == args.rounds - 1:
            print(f"[round {k:3d}] loss {float(m.loss):.4f} "
                  f"alpha {float(m.alpha):.3f} sent {int(m.sent_clients)}"
                  f"/{fl.n_clients} uplink {bits/1e9:.2f} Gbit")
    return rows


if __name__ == "__main__":
    main()
