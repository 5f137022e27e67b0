"""Synthetic federated datasets: a copy of the reference's numpy factories
(``repro/data/synthetic.py``) that this slice runs.

* ``femnist_like`` — 62-class image classification with the paper's
  unbalancing procedure (footnote 6), datasets 1-3 of decreasing balance.
* ``cifar_like``   — the balanced control pool (Appendix G).
* ``charlm``       — the Shakespeare-like next-character pool (Sec. 4.2,
  Figs. 6-7): ``CHARLM_VOCAB`` symbols, ``tokens``/``targets`` windows.
* ``eval_split``   — a held-out pool from the same generative process.
* ``quadratics``   — the heterogeneous quadratic clients of the quickstart.

Pure numpy, so the same ``Generator`` gives bit-identical client data and
``sample_round_batches`` output in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class FederatedDataset:
    """client_data[i] = dict of numpy arrays (first axis = examples)."""

    client_data: list
    num_classes: int
    input_dim: int

    @property
    def n_clients(self):
        return len(self.client_data)

    def sizes(self):
        return np.array([len(next(iter(d.values()))) for d in self.client_data])

    def sample_round_batches(self, rng, clients, max_steps, batch_size, local_epoch=True):
        """Returns dict of arrays (len(clients), max_steps, batch_size, ...)
        plus ``_step_mask`` (len(clients), max_steps).

        ``local_epoch=True`` reproduces the paper's setting: each client runs
        ~1 epoch over its local data, so clients with little data take fewer
        effective steps (masked out) — this is exactly what makes update
        norms heterogeneous and OCS useful.
        """
        out = None
        masks = []
        for ci in clients:
            data = self.client_data[ci]
            n = len(next(iter(data.values())))
            steps_i = max(1, min(max_steps, -(-n // batch_size))) if local_epoch else max_steps
            perm = rng.permutation(n)
            take = np.resize(perm, (max_steps, batch_size))
            sel = {k: v[take] for k, v in data.items()}
            mask = (np.arange(max_steps) < steps_i).astype(np.float32)
            masks.append(mask)
            if out is None:
                out = {k: [v] for k, v in sel.items()}
            else:
                for k, v in sel.items():
                    out[k].append(v)
        batch = {k: np.stack(v) for k, v in out.items()}
        batch["_step_mask"] = np.stack(masks)
        return batch


def _class_means(num_classes, dim, scale=4.0):
    # fixed generator: train and eval splits share the generative process
    rng = np.random.default_rng(123457)
    return rng.normal(size=(num_classes, dim)).astype(np.float32) * scale / np.sqrt(dim)


def femnist_like(
    dataset_id: int = 1,
    n_clients: int = 128,
    num_classes: int = 62,
    dim: int = 784,
    base_examples: int = 120,
    dirichlet: float = 0.5,
    seed: int = 0,
) -> FederatedDataset:
    """dataset_id 1/2/3 = increasingly unbalanced (paper Fig. 2).

    Unbalance procedure (paper footnote 6): for a client with n_c examples,
    keep unchanged if n_c <= a or n_c >= b; else with prob s drop the client,
    with prob 1-s keep only a examples.
    """
    s, a, b = {1: (0.9, 12, 110), 2: (0.75, 20, 100), 3: (0.5, 30, 90)}[dataset_id]
    rng = np.random.default_rng(seed + dataset_id)
    means = _class_means(num_classes, dim)
    clients = []
    while len(clients) < n_clients:
        n_c = int(rng.lognormal(np.log(base_examples), 0.5))
        n_c = max(8, min(n_c, 400))
        if a < n_c < b:
            if rng.random() < s:
                continue  # client dropped from the pool
            n_c = a
        label_probs = rng.dirichlet(np.full(num_classes, dirichlet))
        labels = rng.choice(num_classes, size=n_c, p=label_probs)
        x = means[labels] + rng.normal(size=(n_c, dim)).astype(np.float32) * 0.25
        clients.append({"x": x.astype(np.float32), "y": labels.astype(np.int32)})
    return FederatedDataset(clients, num_classes, dim)


def cifar_like(
    n_clients: int = 128, num_classes: int = 100, dim: int = 512,
    per_client: int = 100, dirichlet: float = 1.0, seed: int = 7,
) -> FederatedDataset:
    rng = np.random.default_rng(seed)
    means = _class_means(num_classes, dim)
    clients = []
    for _ in range(n_clients):
        label_probs = rng.dirichlet(np.full(num_classes, dirichlet))
        labels = rng.choice(num_classes, size=per_client, p=label_probs)
        x = means[labels] + rng.normal(size=(per_client, dim)).astype(np.float32) * 0.25
        clients.append({"x": x.astype(np.float32), "y": labels.astype(np.int32)})
    return FederatedDataset(clients, num_classes, dim)


def eval_split(ds_fn, n_examples: int = 2048, seed: int = 999, **kw):
    """Held-out pool drawn from the same generative process."""
    ds = ds_fn(seed=seed, n_clients=max(8, n_examples // 64), **kw)
    x = np.concatenate([c["x"] for c in ds.client_data])[:n_examples]
    y = np.concatenate([c["y"] for c in ds.client_data])[:n_examples]
    return {"x": x, "y": y}


# ---------------------------------------------------------------------------
# Shakespeare-like char LM


CHARLM_VOCAB = 86


def charlm(
    n_clients: int = 715, seq_len: int = 5, chars_per_client: int = 800, seed: int = 3,
) -> FederatedDataset:
    rng = np.random.default_rng(seed)
    v = CHARLM_VOCAB
    # one global order-1 transition matrix + per-client temperature/shift;
    # concentrated dirichlet -> peaky transitions (learnable structure, like
    # real text), mild per-client variation (heterogeneity without chaos).
    base = rng.dirichlet(np.full(v, 0.02), size=v)
    clients = []
    for _ in range(n_clients):
        shift = rng.integers(0, 4)
        temp = rng.uniform(0.8, 1.25)
        trans = np.roll(base, shift, axis=1) ** temp
        trans = trans + 1e-6
        trans /= trans.sum(axis=1, keepdims=True)
        n_chars = int(rng.lognormal(np.log(chars_per_client), 0.8))
        n_chars = max(seq_len * 8, min(n_chars, 4000))
        text = np.empty(n_chars, np.int32)
        text[0] = rng.integers(0, v)
        for t in range(1, n_chars):
            text[t] = rng.choice(v, p=trans[text[t - 1]])
        n_seq = n_chars // (seq_len + 1)
        chunk = text[: n_seq * (seq_len + 1)].reshape(n_seq, seq_len + 1)
        clients.append(
            {"tokens": chunk[:, :-1].astype(np.int32), "targets": chunk[:, 1:].astype(np.int32)}
        )
    return FederatedDataset(clients, v, seq_len)


def quadratics(n_clients: int = 16, dim: int = 10, hetero: float = 1.0, seed: int = 0):
    """f_i(x) = 0.5 (x-c_i)^T A_i (x-c_i); returns (A (n,d,d), c (n,d), x*)."""
    rng = np.random.default_rng(seed)
    a = []
    for _ in range(n_clients):
        q = rng.normal(size=(dim, dim))
        eig = rng.uniform(0.5, 2.0, size=dim)
        qq, _ = np.linalg.qr(q)
        a.append((qq * eig) @ qq.T)
    a = np.stack(a).astype(np.float32)
    c = (rng.normal(size=(n_clients, dim)) * hetero).astype(np.float32)
    # global optimum of (1/n) sum f_i: solve (sum A_i) x = sum A_i c_i
    x_star = np.linalg.solve(a.sum(0), np.einsum("nij,nj->i", a, c)).astype(np.float32)
    return a, c, x_star
