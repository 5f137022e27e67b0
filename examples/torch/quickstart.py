"""Quickstart: optimal client sampling in ~40 lines, on the PyTorch port
(``repro_torch``; the counterpart of ``examples/quickstart.py``).

Eight clients hold heterogeneous quadratic objectives; each round every
client computes its gradient, but only m=3 (in expectation) transmit —
chosen by the paper's optimal formula from update norms alone.  Compare the
distance-to-optimum against uniform sampling at the same budget.

  PYTHONPATH=src python examples/torch/quickstart.py                # on the GPU
  PYTHONPATH=src python examples/torch/quickstart.py --device cpu
"""

import argparse

import numpy as np
import torch

from repro_torch import rng
from repro_torch._device import resolve_device
from repro_torch.core import sample_and_aggregate
from repro_torch.data import quadratics

N, DIM, M = 8, 12, 3
SAMPLERS = ("full", "optimal", "aocs", "uniform")
# heterogeneous client scales: a few clients' updates matter much more
SCALE = (0.05, 0.05, 0.1, 0.1, 0.2, 0.5, 1.0, 6.0)


def problem(device):
    """``(a, c, x_star)`` on ``device``: the scaled quadratics and their
    optimum, solved in numpy from the scaled float32 ``a``."""
    a, c, _ = quadratics(n_clients=N, dim=DIM, hetero=2.0, seed=0)
    a = torch.from_numpy(a) * torch.tensor(SCALE)[:, None, None]
    an = a.numpy()
    x_star = np.linalg.solve(an.sum(0), np.einsum("nij,nj->i", an, c))
    return a.to(device), torch.from_numpy(c).to(device), torch.from_numpy(x_star).to(device)


def run(sampler: str, rounds: int, device) -> float:
    a, c, x_star = problem(device)
    w = torch.full((N,), 1.0 / N, device=device)
    key = rng.PRNGKey(0, device)
    x = torch.zeros(DIM, device=device)
    for k in range(rounds):
        grads = torch.einsum("nij,nj->ni", a, x[None, :] - c)       # each client's U_i
        res = sample_and_aggregate({"g": grads}, w, M, rng.fold_in(key, k), sampler=sampler)
        x = x - 0.5 / (1 + 0.02 * k) * res.aggregate["g"]          # master step
    return float(torch.linalg.norm(x - x_star))


def main(argv=None):
    ap = argparse.ArgumentParser(description="OCS against uniform sampling on quadratics")
    ap.add_argument("--rounds", type=int, default=400)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    errs = {}
    for sampler in SAMPLERS:
        errs[sampler] = run(sampler, args.rounds, device)
        sent = N if sampler == "full" else M
        print(f"{sampler:8s}  ~{sent} clients/round  ||x - x*|| = {errs[sampler]:.4f}")
    return errs


if __name__ == "__main__":
    main()
