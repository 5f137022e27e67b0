"""Paper Section 5.3 on the PyTorch port (``repro_torch``; the counterpart
of ``examples/shakespeare_gru.py``): Shakespeare(-like) next-character
prediction with the paper's 2-layer GRU under FedAvg + OCS, n clients
sampled per round from the 715-client pool.

  PYTHONPATH=src python examples/torch/shakespeare_gru.py --rounds 60 --n 32 --m 2
  PYTHONPATH=src python examples/torch/shakespeare_gru.py --device cpu
"""

import argparse

import numpy as np

from repro_torch.configs.base import FLConfig
from repro_torch.data import charlm
from repro_torch.fl.trainer import run_training
from repro_torch.models.simple import gru_lm


def main(argv=None):
    ap = argparse.ArgumentParser(description="FedAvg + OCS with the paper's GRU")
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--pool", type=int, default=240)
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--m", type=int, default=2)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)

    ds = charlm(n_clients=args.pool, seed=3)
    rng = np.random.default_rng(42)
    evb = ds.sample_round_batches(rng, list(range(8)), 4, 32)
    ev = {"tokens": evb["tokens"].reshape(-1, 5)[:512],
          "targets": evb["targets"].reshape(-1, 5)[:512]}
    init, loss, acc = gru_lm(ds.num_classes, hidden=args.hidden, layers=2)
    print(f"charlm pool={ds.n_clients}, vocab=86, n={args.n}, m={args.m}")

    out = {}
    for sampler, lr in (("full", 1.0), ("aocs", 1.0), ("uniform", 0.5)):
        fl = FLConfig(n_clients=args.n, expected_clients=args.m, sampler=sampler,
                      local_steps=6, lr_local=lr)
        _, hist = run_training(
            ds, init, loss, fl, rounds=args.rounds, batch_size=8,
            eval_fn=acc, eval_batch=ev, eval_every=10, seed=1, device=args.device,
        )
        out[sampler] = hist
        print(f"{sampler:8s} eta_l={lr:<6} next-char acc {hist.acc[-1]:.3f} "
              f"loss {hist.loss[-1]:.3f} uplink {hist.bits[-1]/1e9:.2f} Gbit")
    return out


if __name__ == "__main__":
    main()
