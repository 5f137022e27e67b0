"""End-to-end driver (paper Section 5.2) on the PyTorch port
(``repro_torch``; the counterpart of ``examples/femnist_fedavg.py``): FedAvg
with Optimal Client Sampling on the unbalanced FEMNIST-like dataset, a few
hundred communication rounds, comparing full participation / OCS / uniform
sampling exactly like Figure 3.

  PYTHONPATH=src python examples/torch/femnist_fedavg.py             # on the GPU
  PYTHONPATH=src python examples/torch/femnist_fedavg.py --rounds 150 --m 6 --device cpu
"""

import argparse

import numpy as np

from repro_torch.configs.base import FLConfig
from repro_torch.data import eval_split, femnist_like
from repro_torch.fl.trainer import run_training
from repro_torch.models.simple import mlp_classifier


def main(argv=None):
    ap = argparse.ArgumentParser(description="FedAvg + OCS on FEMNIST-like data")
    ap.add_argument("--rounds", type=int, default=120)
    ap.add_argument("--dataset", type=int, default=1, choices=[1, 2, 3])
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--m", type=int, default=3)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)

    ds = femnist_like(dataset_id=args.dataset, n_clients=96, seed=0)
    ev = eval_split(femnist_like, 2048, dataset_id=args.dataset)
    init, loss, acc = mlp_classifier(ds.input_dim, ds.num_classes, hidden=args.hidden)
    print(f"FEMNIST-like dataset {args.dataset}: pool={ds.n_clients} clients, "
          f"sizes {ds.sizes().min()}..{ds.sizes().max()}, n={args.n}, m={args.m}")

    out = {}
    for sampler, lr in (("full", 0.125), ("aocs", 0.125), ("uniform", 0.03125)):
        fl = FLConfig(n_clients=args.n, expected_clients=args.m, sampler=sampler,
                      local_steps=8, lr_local=lr)
        _, hist = run_training(
            ds, init, loss, fl, rounds=args.rounds, batch_size=20,
            eval_fn=acc, eval_batch=ev, eval_every=10, seed=1, device=args.device,
        )
        out[sampler] = hist
        print(
            f"{sampler:8s} eta_l={lr:<8} final acc {hist.acc[-1]:.3f} "
            f"loss {hist.loss[-1]:.3f} alpha~{np.mean(hist.alpha[10:]):.2f} "
            f"uplink {hist.bits[-1]/1e9:.2f} Gbit "
            f"(sent {np.mean(hist.sent):.1f}/{args.n} clients/round)"
        )
    return out


if __name__ == "__main__":
    main()
