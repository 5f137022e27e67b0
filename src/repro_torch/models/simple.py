"""The small models of the paper's cells, in the reference's parameter
layout (``repro/models/simple.py``).

* ``mlp_classifier`` (femnist and cifar cells): a dict ``w1 (in, hidden),
  b1, w2, b2, w3, b3`` used as ``x @ w1 + b1`` — jax's layout, not
  ``nn.Linear``'s transposed weight.
* ``gru_lm`` (charlm cells): ``embed (vocab, embed)``, ``out (hidden,
  vocab)``, ``out_b`` and per layer ``gru{i}: {wx (in, 3h), wh (h, 3h), b}``.

The reference's parameters convert leaf by leaf and the client-major update
matrix has the same columns in both packages.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch import rng


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, mask=None) -> torch.Tensor:
    """Mean token negative log-likelihood (``repro/models/model.py``)."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return torch.mean(nll)
    mask = mask.to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def mlp_logits(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits of the three-layer ReLU MLP with parameter dict ``p``."""
    h = torch.relu(x @ p["w1"] + p["b1"])
    h = torch.relu(h @ p["w2"] + p["b2"])
    return h @ p["w3"] + p["b3"]


def mlp_init(key: torch.Tensor, input_dim: int, num_classes: int, hidden: int) -> dict:
    """Random parameters on ``key``'s device, drawn as the reference draws them."""
    k1, k2, k3 = rng.split(key, 3)
    dev = key.device
    s1 = 1 / torch.sqrt(torch.tensor(float(input_dim), device=dev))
    s2 = 1 / torch.sqrt(torch.tensor(float(hidden), device=dev))
    return {
        "w1": rng.normal(k1, (input_dim, hidden)) * s1,
        "b1": torch.zeros((hidden,), device=dev),
        "w2": rng.normal(k2, (hidden, hidden)) * s2,
        "b2": torch.zeros((hidden,), device=dev),
        "w3": rng.normal(k3, (hidden, num_classes)) * s2,
        "b3": torch.zeros((num_classes,), device=dev),
    }


class MLPClassifier(nn.Module):
    """Three-layer ReLU MLP over flat features, with parameters in jax's layout."""

    def __init__(self, input_dim: int, num_classes: int, hidden: int = 128,
                 key: torch.Tensor | None = None):
        super().__init__()
        key = rng.PRNGKey(0) if key is None else key
        params = mlp_init(key, input_dim, num_classes, hidden)
        for name, value in params.items():
            self.register_parameter(name, nn.Parameter(value))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_logits(dict(self.named_parameters()), x)


def mlp_classifier(input_dim: int, num_classes: int, hidden: int = 128):
    """``(init, loss, accuracy)`` over parameter dicts, like the reference:
    ``init(key) -> params``, ``loss(params, batch) -> (ce, {"ce": ce})``,
    ``accuracy(params, batch) -> scalar``."""

    def init(key):
        return mlp_init(key, input_dim, num_classes, hidden)

    def loss(p, batch):
        ce = cross_entropy(mlp_logits(p, batch["x"]), batch["y"])
        return ce, {"ce": ce}

    def accuracy(p, batch):
        pred = torch.argmax(mlp_logits(p, batch["x"]), dim=-1)
        return torch.mean((pred == batch["y"].long()).to(torch.float32))

    return init, loss, accuracy


def _gru_init(key: torch.Tensor, in_dim: int, h: int) -> dict:
    ks = rng.split(key, 3)
    s = 1 / torch.sqrt(torch.tensor(float(in_dim + h), device=key.device))
    return {
        "wx": rng.normal(ks[0], (in_dim, 3 * h)) * s,
        "wh": rng.normal(ks[1], (h, 3 * h)) * s,
        "b": torch.zeros((3 * h,), device=key.device),
    }


def gru_lm_init(key: torch.Tensor, vocab: int, hidden: int, layers: int, embed: int) -> dict:
    """Random parameters on ``key``'s device, drawn as the reference draws them."""
    ks = rng.split(key, layers + 2)
    dev = key.device
    p = {
        "embed": rng.normal(ks[0], (vocab, embed)) * 0.05,
        "out": rng.normal(ks[1], (hidden, vocab)) / torch.sqrt(
            torch.tensor(float(hidden), device=dev)),
        "out_b": torch.zeros((vocab,), device=dev),
    }
    for i in range(layers):
        p[f"gru{i}"] = _gru_init(ks[2 + i], embed if i == 0 else hidden, hidden)
    return p


def gru_layer(p: dict, xs: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """One GRU layer over ``xs (b, T, in)`` from state ``h (b, hidden)``;
    returns every step's state ``(b, T, hidden)``.

    Gates r, z, n in that order along the ``3h`` axis, the bias on the input
    side only: ``n = tanh(gx_n + r * gh_n)``, ``h = (1 - z) * n + z * h``.
    An explicit loop over time with plain products: ``nn.GRU``'s cuDNN
    kernel does not batch under ``torch.func.vmap``, and its biases are laid
    out differently.
    """
    hd = h.shape[-1]
    outs = []
    for t in range(xs.shape[-2]):
        gx = xs[..., t, :] @ p["wx"] + p["b"]
        gh = h @ p["wh"]
        r = torch.sigmoid(gx[..., :hd] + gh[..., :hd])
        z = torch.sigmoid(gx[..., hd:2 * hd] + gh[..., hd:2 * hd])
        n = torch.tanh(gx[..., 2 * hd:] + r * gh[..., 2 * hd:])
        h = (1 - z) * n + z * h
        outs.append(h)
    return torch.stack(outs, dim=-2)


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]`` as a one-hot product ``(…, vocab) @ (vocab, embed)``.

    Exact in the forward pass (one nonzero term per sum; with TF32 off), and
    its gradient is a matrix product whose reduction order is fixed, where
    the gradient of an index (an index-add) accumulates with atomics on
    CUDA: a second run would draw other norms, and so other masks.
    """
    vocab = table.shape[0]
    classes = torch.arange(vocab, device=tokens.device, dtype=tokens.dtype)
    one_hot = (tokens[..., None] == classes).to(table.dtype)
    return one_hot @ table


def gru_lm_logits(p: dict, tokens: torch.Tensor, layers: int) -> torch.Tensor:
    """Next-character logits ``(b, T, vocab)`` of ``tokens (b, T)``."""
    h = embed_tokens(p["embed"], tokens)
    for i in range(layers):
        cell = p[f"gru{i}"]
        h0 = torch.zeros(h.shape[:-2] + (cell["wh"].shape[0],), dtype=h.dtype,
                         device=h.device)
        h = gru_layer(cell, h, h0)
    return h @ p["out"] + p["out_b"]


def gru_lm(vocab: int, hidden: int = 256, layers: int = 2, embed: int = 64):
    """The paper's Shakespeare architecture: a ``layers``-layer GRU
    next-character model.  ``(init, loss, accuracy)`` as
    :func:`mlp_classifier`; batches carry ``tokens`` and ``targets``."""

    def init(key):
        return gru_lm_init(key, vocab, hidden, layers, embed)

    def loss(p, batch):
        ce = cross_entropy(gru_lm_logits(p, batch["tokens"], layers), batch["targets"])
        return ce, {"ce": ce}

    def accuracy(p, batch):
        pred = torch.argmax(gru_lm_logits(p, batch["tokens"], layers), dim=-1)
        return torch.mean((pred == batch["targets"].long()).to(torch.float32))

    return init, loss, accuracy
